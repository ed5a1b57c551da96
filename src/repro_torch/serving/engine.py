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
    evicted (recompute-style) and re-admitted later; a request evicted
    ``max_preemptions`` times (8) is parked until the queue drains.

Resilience contract (the JAX engine's, ``tests/test_torch_faults.py``):
requests finish with a :class:`~repro_torch.serving.errors.FinishReason`;
admission is bounded (``max_waiting`` -> :class:`EngineOverloaded`) and
validated (:class:`RequestRejected`); per-request deadlines are enforced
against the engine's step clock (one tick a :meth:`step`, plus the
``decode.slow`` fault's ticks); a failed prefill group is rolled back and
retried, up to ``MAX_PREFILL_FAULTS``; a preemption storm parks its
victims.  Every recovery path is injectable through
:mod:`repro_torch.faults`.

Where the port differs on purpose: no recovery reroutes to a plain path.
A decode step whose logits are not finite finishes the affected slots with
``ERROR`` (the JAX engine first re-runs the step on its XLA fallback; here
that would hide the kernel).  Under ``guard=True`` a decode step that
raises (a kernel failure, ``KernelQuarantined``) finishes every request of
that step with ``ERROR`` and the engine goes on serving; JAX never meets
this case, because its fallback absorbs kernel failures while tracing.
With ``guard=False`` the error propagates.  A failure while the decode
graph is captured leaves it uncaptured, and the next step captures afresh.

Telemetry (:mod:`repro_torch.obs`): while a tracer is active the engine
emits JAX's spans (``engine.step``, ``prefill``, ``decode``,
``decode.consume``), one async event track per request (``request``
begin, ``admitted``, ``preempted``, ``request`` end with its finish
reason), and the ``serving/latency/{queue_wait_s,ttft_s,tpot_s}``
histograms; with none, it reads no clock.  Live engines' counters are the
``serving/engine`` source of ``obs.snapshot()``.

Serving knobs (JAX's, on the pinned numerics config; all off by default,
and then every path below is the single-shot engine's):

  * ``prefix_cache``: full prompt pages are kept in a content-keyed tree
    (:class:`~repro_torch.serving.prefix_cache.PrefixCache`); an admission
    whose prompt prefix is cached maps those pages (refcounted, never
    written: a write into a shared page splits it first) and prefills only
    the tail;
  * ``chunked_prefill`` (tokens, rounded up to a page multiple): a prompt
    longer than a chunk is prefilled one chunk a step, interleaved with
    the decode steps, through ``models.lm.prefill_chunk`` over a
    per-request f32 scratch; each finished chunk's whole pages are
    written to the pool;
  * ``async_sched``: :meth:`Engine.step` leaves its decode step in flight
    and consumes it at the top of the next step, so the host's scheduling
    of step N + 1 overlaps the card's step N; the tokens are those of the
    synchronous engine, because the consume comes before every other
    change to the engine's state.

With f32 pools (``cache_dtype=torch.float32``) a reused page is bitwise
what a fresh prefill writes, so each knob leaves greedy tokens unchanged;
kernel 3 reads f32 pools on the card through its f32 instantiation.
:meth:`Engine.defragment` compacts the live pages in place.

Under a mesh (captured from ``parallel.ctx`` at construction, or passed as
``mesh=``; JAX :139-151) the page pools are DTensors laid out by
:func:`_pool_spec` (KV heads on ``model``), block tables and lengths stay
whole on every rank, and every step runs under the mesh scope, so kernel 3
and the model's products run per shard (``kernels/shmap.py``).  The
parameters are taken as given: lay them out with
``parallel.sharding.param_specs`` first.  Over a gloo process group the
decode step runs eagerly (a gloo collective cannot be captured in a CUDA
graph); :meth:`Engine.stats` says so (``decode_graph``,
``decode_graph_reason``).

Numerics contract (tests/test_torch_serving.py): with parameters bridged
from JAX, greedy output is token-identical to the JAX engine's.

The engine pins its numerics config at construction (``numerics_config``,
else the caller's ``numerics.active()``), as JAX's does: its model handle
runs every prefill, eager decode step, the decode graph's warm-up and its
capture under that config, so a ``numerics.use`` entered mid-serve changes
none of them (and no replay re-runs Python).
"""
from __future__ import annotations

import contextlib
import math
import time
import weakref

import numpy as np
import torch

from repro_torch import faults, numerics, resolve_device
from repro_torch.kernels import (guard, tcec_attention, tcec_matmul,
                                 tcec_paged_attention)
from repro_torch.models import get_model
from repro_torch.models.modules import tree_map
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import current as _current_tracer
from . import sampling
from .errors import (EngineOverloaded, FinishReason, RequestRejected,
                     RequestResult)
from .kv_cache import (DEFAULT_PAGE_SIZE, PagePool, inverse_permutation,
                       load_pages_into_scratch, permute_pages,
                       write_prompt_pages, write_span_pages)
from .prefix_cache import PrefixCache
from .sampling import SamplingParams, draw_uniform, new_generator, sample_one
from .scheduler import Request, RequestState, Scheduler

# live engines, summed into repro_torch.obs snapshots at read time (weak
# refs: registering never keeps a dropped engine's pools alive)
_LIVE_ENGINES: "weakref.WeakSet[Engine]" = weakref.WeakSet()


def _engines_source() -> dict:
    out: dict[str, int] = {}
    for eng in list(_LIVE_ENGINES):
        stats = {**eng._stats, "clock": eng.clock,
                 "prefills": eng.n_prefills,
                 "prefill_chunks": eng.n_prefill_chunks,
                 "decode_steps": eng.n_decode_steps,
                 "preemptions": eng.sched.n_preemptions,
                 "parks": eng.sched.n_parks}
        for k, v in stats.items():
            out[k] = out.get(k, 0) + int(v)
    return out


_obs_metrics.register_source("serving/engine", _engines_source)

# The decode step's per-slot inputs, packed into one byte buffer that goes
# to the device in one copy: name, dtype, columns (None: one a slot).  f64
# comes first, so every field starts at a multiple of its item size;
# ``poison`` is the ``decode.nonfinite`` fault mask.
_INPUTS = (("uniforms", torch.float64, None), ("temps", torch.float32, None),
           ("topps", torch.float32, None), ("topks", torch.int32, None),
           ("lengths", torch.int32, None), ("next_tok", torch.int32, None),
           ("block_tables", torch.int32, "maxp"),
           ("poison", torch.bool, None))


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


def _pool_spec(shape, mesh):
    """The spec of one page-pool leaf ``(..., Hkv, hd)`` (JAX :90-103): KV
    heads on ``model`` when divisible (the paged plan's layout), else
    head_dim, else replicated."""
    from repro_torch.parallel import ctx
    from repro_torch.parallel.sharding import P
    msize = ctx.axis_shape(mesh).get("model", 1)
    dims = [None] * len(shape)
    if msize > 1 and len(shape) >= 2:
        if shape[-2] % msize == 0:
            dims[-2] = "model"
        elif shape[-1] % msize == 0:
            dims[-1] = "model"
    return P(*dims)


class Engine:
    """Continuous-batching engine for the dense and MoE families.

    max_slots: decode batch width (inactive slots are masked).
    num_pages: pool size including the reserved scrap page 0.
    page_size: tokens per page.
    max_pages_per_slot: block-table width; a request that outgrows it
        finishes early (``length_cap``), like any server's max context.
    max_waiting: waiting-queue bound; ``add_request`` past it raises
        :class:`EngineOverloaded` (None = unbounded).
    max_preemptions: evictions before a request is parked as a
        preemption-storm victim (None = never park).
    cache_dtype: page-pool element dtype, bf16 (the default) or f32.  The
        prefix cache's parity contract needs f32: a reused page must be
        bitwise what a fresh prefill writes, and the bf16 round trip
        loses that.  Kernel 3 has an instantiation for each.
    device: where the pools live and the steps run (default ``cuda``); the
        parameters must already be there.
    numerics_config: the :class:`repro_torch.numerics.NumericsConfig` every
        step runs under (default: the one active at construction).
    mesh: the ``DeviceMesh`` every step runs under (default: the one
        installed by ``parallel.ctx.use_mesh`` at construction, if any).
    """

    def __init__(self, cfg, params, *, max_slots: int = 4,
                 num_pages: int | None = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 max_pages_per_slot: int | None = None,
                 max_waiting: int | None = None,
                 max_preemptions: int | None = 8,
                 cache_dtype=torch.bfloat16, device=None,
                 numerics_config: numerics.NumericsConfig | None = None,
                 mesh=None):
        from repro_torch.parallel import ctx
        self.numerics_config = numerics_config or numerics.active()
        self.mesh = mesh if mesh is not None else ctx.current_mesh()
        self.model = get_model(cfg, self.numerics_config)
        if self.model.decode_step_paged is None:
            raise ValueError(
                f"family {cfg.family!r} has no paged decode path; use "
                "launch.serve.generate_dense")
        if cache_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"cache_dtype must be torch.bfloat16 or "
                             f"torch.float32, got {cache_dtype}")
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
        self.sched = Scheduler(self.pool, max_slots,
                               max_preemptions=max_preemptions)
        self.max_slots = max_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.max_waiting = max_waiting
        # the deadline clock: one tick a step() (plus injected decode.slow
        # ticks), no wall-clock reads
        self.clock = 0
        self.pools = self.model.init_paged_cache(
            num_pages, page_size, dtype=cache_dtype, device=self.device)
        self.graph_off = None         # why decode is eager, if it is
        if self.device.type != "cuda":
            self.graph_off = self.device.type
        if self.mesh is not None:
            from repro_torch.parallel.sharding import distribute, to_placements
            self.pools = tree_map(
                lambda t: distribute(t, self.mesh, to_placements(
                    _pool_spec(t.shape, self.mesh), self.mesh)), self.pools)
            if self.graph_off is None and _mesh_backend(self.mesh) == "gloo":
                self.graph_off = "gloo"
        # host mirrors of the per-slot device state
        self.block_tables = np.zeros((max_slots, max_pages_per_slot),
                                     np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.next_tok = np.zeros((max_slots,), np.int32)
        self.temps = np.zeros((max_slots,), np.float32)
        self.topks = np.zeros((max_slots,), np.int32)
        self.topps = np.ones((max_slots,), np.float32)
        self.uniforms = np.ones((max_slots,), np.float64)
        self.poison = np.zeros((max_slots,), np.bool_)
        # double-buffered staging of those mirrors: the buffer of step N is
        # not written again before step N + 2, so an asynchronous scheduler
        # may fill the next one while a step is in flight
        pin = self.device.type == "cuda"
        self._staging = [_Staging(max_slots, max_pages_per_slot, pin)
                         for _ in range(2)]
        self._graph: _DecodeGraph | None = None   # captured on first use
        self._requests: dict[int, Request] = {}
        # JAX's counters, plus decode_faults (decode steps that raised
        # under guard=True)
        self._stats = {"guard_trips": 0, "fallback_reruns": 0,
                       "numerics_errors": 0, "rejections": 0, "overloads": 0,
                       "timeouts": 0, "length_caps": 0, "prefill_faults": 0,
                       "prefix_hits": 0, "prefix_tokens_reused": 0,
                       "cow_splits": 0, "prefix_evictions": 0,
                       "decode_faults": 0}
        # the serving knobs; the chunk is rounded up to a page multiple, so
        # every chunk boundary is a page boundary
        nc = self.numerics_config
        self.chunk_tokens = (-(-nc.chunked_prefill // page_size) * page_size
                             if nc.chunked_prefill > 0 else 0)
        self.async_sched = bool(nc.async_sched)
        self.prefix = PrefixCache(self.pool) if nc.prefix_cache else None
        if self.prefix is not None:
            self.sched.evict_cb = self._evict_prefix
        self._inflight = None       # async: the dispatched, unconsumed step
        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_prefill_chunks = 0
        _LIVE_ENGINES.add(self)

    # ------------------------------------------------------- observability
    #
    # Everything below is gated on an active repro_torch.obs tracer: with
    # none there are no spans, no clock reads and no histogram writes.

    def _span(self, name: str, device: bool = False, **args):
        """A tracer span around one engine phase, or a no-op context
        yielding a throwaway args dict when tracing is off.  ``device``:
        the phase queues work on the card, so the span records its device
        edges when the engine runs on one."""
        tr = _current_tracer()
        if tr is None:
            return contextlib.nullcontext(dict(args))
        return tr.span(name, cat="engine",
                       device=device and self.device.type == "cuda", **args)

    @staticmethod
    def _observe_latency(name: str, seconds: float):
        _obs_metrics.observe(f"serving/latency/{name}", seconds)

    def _trace_request_end(self, req: Request):
        tr = _current_tracer()
        if tr is not None:
            tr.async_end("request", req.rid, finish=req.finish_reason,
                         tokens=len(req.out))

    def _trace_preempt(self, req: Request):
        tr = _current_tracer()
        if tr is not None:
            tr.async_instant("preempted", req.rid,
                             n_preemptions=req.n_preemptions)

    # ------------------------------------------------------------ intake

    def add_request(self, prompt, params: SamplingParams | None = None,
                    deadline: int | None = None) -> int:
        """Enqueue a request; returns its rid.

        Raises :class:`RequestRejected` for requests that can never be
        served and :class:`EngineOverloaded` when the waiting queue is at
        ``max_waiting`` (backpressure: retry later).  ``deadline`` is a
        step budget: the request must finish within that many engine clock
        ticks or it is timed out (``finish_reason="timeout"``)."""
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
        if deadline is not None and deadline < 1:
            self._stats["rejections"] += 1
            raise RequestRejected(f"deadline must be >= 1, got {deadline}")
        if (self.max_waiting is not None
                and len(self.sched.waiting) >= self.max_waiting):
            self._stats["overloads"] += 1
            raise EngineOverloaded(
                f"waiting queue is at max_waiting={self.max_waiting}")
        req = self.sched.add(prompt, params)
        req.generator = new_generator(params)
        if deadline is not None:
            req.deadline = self.clock + deadline
        self._requests[req.rid] = req
        tr = _current_tracer()
        if tr is not None:
            req.t_enqueue = tr.now()
            tr.async_begin("request", req.rid, prompt_len=len(prompt),
                           max_tokens=params.max_tokens)
        return req.rid

    # ----------------------------------------------------------- prefill

    def _admit_and_prefill(self):
        # a preempted request may have generated its way past the per-slot
        # cap: finish it from the queue instead of re-admitting it
        cap = min(self.max_pages_per_slot, self.pool.num_pages - 1)
        for req in [r for r in list(self.sched.waiting)
                    + list(self.sched.parked)
                    if self.pool.pages_for(len(r.full_sequence) + 1) > cap]:
            self._stats["length_caps"] += 1
            req.finish_reason = FinishReason.LENGTH_CAP.value
            self.sched.drop(req)
            self._trace_request_end(req)
        plan = (self._plan_admission
                if (self.prefix is not None or self.chunk_tokens) else None)
        admitted = self.sched.admit(plan)
        for req in admitted:
            if req.state is RequestState.PREFILLING:
                if req.shared_pages:
                    self._stats["prefix_hits"] += 1
                    self._stats["prefix_tokens_reused"] += req.prefill_done
                self._start_chunked_prefill(req)
        tr = _current_tracer()
        if tr is not None:
            now = tr.now()
            for req in admitted:
                tr.async_instant("admitted", req.rid, clock=self.clock)
                if req.t_enqueue is not None and req.n_preemptions == 0:
                    self._observe_latency("queue_wait_s",
                                          now - req.t_enqueue)
        ps = self.pool.page_size
        groups: dict[int, list[Request]] = {}
        for req in admitted:
            if req.state is not RequestState.RUNNING:
                continue            # PREFILLING: advanced chunk by chunk
            padded = max(1, -(-len(req.full_sequence) // ps)) * ps
            groups.setdefault(padded, []).append(req)
        for padded, reqs in sorted(groups.items()):
            with self._span("prefill", device=True, batch=len(reqs),
                            padded=padded):
                self._prefill_group(padded, reqs)

    def _prefill_group(self, padded: int, reqs: list[Request]):
        ps = self.pool.page_size
        toks = np.zeros((len(reqs), padded), np.int64)
        for i, req in enumerate(reqs):
            toks[i, :len(req.full_sequence)] = req.full_sequence
        try:
            faults.raise_if("prefill")
            logits, kv = self.model.prefill(
                self.params, torch.from_numpy(toks).to(self.device))
            logits = _whole(logits)
        except Exception as exc:   # rolled back (or re-raised) below
            self._on_prefill_failure(reqs, exc)
            return
        self.n_prefills += 1
        pages = np.asarray([req.pages[:padded // ps] for req in reqs],
                           np.int64)
        write_prompt_pages(self.pools, kv,
                           torch.from_numpy(pages).to(self.device))
        if self.prefix is not None:
            # before the accept loop: a request finishing on its first
            # token frees its own references, the tree's keep the pages
            for req in reqs:
                self.prefix.insert(req.full_sequence, req.pages)
        for i, req in enumerate(reqs):
            plen = len(req.full_sequence)
            self.lengths[req.slot] = plen
            self._sync_slot(req)
            self._first_token(
                req, logits[i, plen - 1, :self.cfg.vocab_size].float())

    def _first_token(self, req: Request, row: torch.Tensor):
        """Sample a prefilled request's first token from its last prompt
        position's logits ``row``; a non-finite row fails the request."""
        if not bool(torch.isfinite(row).all()):
            self._stats["numerics_errors"] += 1
            self._finish(req, FinishReason.ERROR)
            return
        self._accept_token(req, sample_one(row, req.params, req.generator))

    # a request whose prefill fails this many times finishes with
    # finish_reason="error" instead of retrying forever
    MAX_PREFILL_FAULTS = 3

    def _on_prefill_failure(self, reqs: list[Request], exc: Exception):
        """Roll a failed prefill group back: nothing landed on the device
        yet (the failure came before ``write_prompt_pages``), so each
        request is un-admitted to the head of the queue and retried on the
        same kernel path next step (a retry, not a fallback).  Persistent
        failers finish with ``ERROR`` after :data:`MAX_PREFILL_FAULTS`
        attempts.  An injected fault is always caught; any other error only
        under ``guard=True``, and propagates otherwise."""
        if (not isinstance(exc, faults.FaultInjected)
                and not self.numerics_config.guard):
            raise exc
        self._stats["prefill_faults"] += 1
        # reversed: appendleft-ing restores the group's FIFO order
        for req in reversed(reqs):
            req.n_prefill_faults += 1
            if req.n_prefill_faults >= self.MAX_PREFILL_FAULTS:
                self._stats["numerics_errors"] += 1
                self._finish(req, FinishReason.ERROR)
            else:
                self.sched.unadmit(req)

    # ------------------------------------- shared prefixes / chunked prefill

    def _evict_prefix(self, n: int) -> int:
        """The scheduler's eviction hook: reclaim ``n`` pages from the
        prefix cache's LRU tail when the pool runs dry."""
        freed = self.prefix.evict_for(n)
        self._stats["prefix_evictions"] += freed
        return freed

    def _plan_admission(self, req: Request):
        """The admission plan for :meth:`Scheduler.admit` when the prefix
        cache or chunked prefill is on: None for the single-shot route,
        else ``(shared, start, reserve)``: the cached pages mapped at the
        head of the block table, the token prefill resumes from, and the
        pages to allocate for the first chunk.  The last prompt position is
        always recomputed (its logits give the first token), so a hit on
        the whole prompt still rewrites its last page: a copy-on-write
        split."""
        ps = self.pool.page_size
        seq = req.full_sequence
        plen = len(seq)
        padded = max(1, -(-plen // ps)) * ps
        shared, start = [], 0
        if self.prefix is not None:
            pages, matched = self.prefix.match(seq)
            hit = min(matched, plen - 1)
            # resume on the chunk grid; the overlap [start, matched) is
            # recomputed bitwise and splits its pages
            grid = self.chunk_tokens or ps
            start = (hit // grid) * grid
            shared = pages if start > 0 else []
            if not shared:
                start = 0
        if not shared and not (self.chunk_tokens
                               and plen > self.chunk_tokens):
            return None
        end = (min(start + self.chunk_tokens, padded)
               if self.chunk_tokens else padded)
        return shared, start, max(0, -(-end // ps) - len(shared))

    def _start_chunked_prefill(self, req: Request):
        """A PREFILLING admission's f32 dense scratch, sized to the chunk
        grid and holding the shared prefix's K/V: chunk attention reads
        the earlier chunks' exact values from it, so the rows match a
        monolithic prefill's bitwise; only finished whole pages go to the
        pool."""
        ps = self.pool.page_size
        padded = max(1, -(-len(req.full_sequence) // ps)) * ps
        T = padded
        if self.chunk_tokens:
            T = -(-padded // self.chunk_tokens) * self.chunk_tokens
        req.scratch = self.model.init_cache(1, T, dtype=torch.float32,
                                            device=self.device)
        n_load = req.prefill_done // ps
        if n_load:
            load_pages_into_scratch(req.scratch, self.pools, torch.tensor(
                req.pages[:n_load], device=self.device))

    def _preempt_prefilling(self, req: Request):
        """A dry pool mid-prefill: preempt the request itself (its
        re-admission replans), unless the pool could never hold it, which
        finishes it with ``ERROR``."""
        slot = req.slot
        if len(req.pages) + 1 >= self.pool.num_pages:
            self._finish(req, FinishReason.ERROR)
            return
        self.sched.preempt(req)
        self._clear_slot(slot)
        self._trace_preempt(req)

    def _prefill_chunk_step(self):
        """Advance every PREFILLING request by one chunk, in admission
        order, before the step's decode: a long prompt no longer stalls
        every resident decode for its whole prefill."""
        cands = sorted((r for r in self.sched.running.values()
                        if r.state is RequestState.PREFILLING),
                       key=self.sched.admitted_at)
        for req in cands:
            if not self._advance_chunk(req):
                return

    def _advance_chunk(self, req: Request) -> bool:
        """One chunk of one request; False ends this step's chunk phase
        (a dry pool or a failed chunk: retried next step)."""
        ps = self.pool.page_size
        seq = req.full_sequence
        plen = len(seq)
        padded = max(1, -(-plen // ps)) * ps
        start = req.prefill_done
        C = self.chunk_tokens or (padded - start)
        with self._span("prefill.chunk", device=True, rid=req.rid,
                        start=start, chunk=C):
            # the whole pages this chunk writes: [start, min(start + C,
            # padded)); a last chunk's padding past the prompt's pages is
            # never written
            lo, hi = start // ps, -(-min(start + C, padded) // ps)
            need = hi - len(req.pages)
            if need > 0 and self.sched.reserve(req, need) is None:
                self._preempt_prefilling(req)
                return False
            # copy-on-write: never write a page another owner references
            for idx in range(lo, hi):
                if self.pool.refcount(req.pages[idx]) > 1:
                    got = self.sched._alloc(1)
                    if got is None:
                        self._preempt_prefilling(req)
                        return False
                    self.pool.free([req.pages[idx]])
                    req.pages[idx] = got[0]
                    self._stats["cow_splits"] += 1
            toks = np.zeros((1, C), np.int64)
            n = min(plen, start + C) - start
            toks[0, :n] = seq[start:start + n]
            try:
                faults.raise_if("prefill.chunk")
                logits = _whole(self.model.prefill_chunk(
                    self.params, req.scratch,
                    torch.from_numpy(toks).to(self.device), start))
            except Exception as exc:   # rolled back (or re-raised) below
                self._on_prefill_failure([req], exc)
                return False
            self.n_prefill_chunks += 1
            write_span_pages(self.pools, req.scratch, start, torch.tensor(
                req.pages[lo:hi], device=self.device))
            req.prefill_done = start + C
            if req.prefill_done < padded:
                return True
            # the prompt is in: this chunk holds position plen - 1, whose
            # logits give the first token (the monolithic path's draw)
            req.scratch = None
            req.state = RequestState.RUNNING
            if self.prefix is not None:
                self.prefix.insert(seq, req.pages)
            self.lengths[req.slot] = plen
            self._sync_slot(req)
            self._first_token(req, logits[0, plen - 1 - start,
                                          :self.cfg.vocab_size].float())
        return True

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
        tr = _current_tracer()
        if tr is not None and req.t_enqueue is not None:
            now = tr.now()
            if req.t_last_token is None:
                self._observe_latency("ttft_s", now - req.t_enqueue)
            else:
                self._observe_latency("tpot_s", now - req.t_last_token)
            req.t_last_token = now
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
        self._trace_request_end(req)

    # ------------------------------------------------------------ decode

    def _ensure_pages(self):
        """Every running slot must own the page its next token writes to;
        grow (possibly preempting) before the step, not during it."""
        ps = self.pool.page_size
        for req in sorted(self.sched.running.values(),
                          key=self.sched.admitted_at):
            if req.slot is None:        # preempted by an earlier grow
                continue
            if req.state is not RequestState.RUNNING:
                continue                # PREFILLING: pages come per chunk
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
                    # transient exhaustion (an injected alloc fault):
                    # requeue and retry
                    self.sched.preempt(req)
                    self._clear_slot(slot)
                    self._trace_preempt(req)
            for rid, slot in before.items():
                r = self._requests[rid]
                if r.slot is None and rid != req.rid:
                    self._clear_slot(slot)      # preempted: mask its slot
                    self._trace_preempt(r)
            if grown:
                self._sync_slot(req)

    def _poison_mask(self) -> np.ndarray:
        """Poll the ``decode.nonfinite`` fault site: the (max_slots,) mask
        of slots whose logits this step poisons to NaN (all False leaves
        the step's logits bitwise as they were)."""
        poison = np.zeros((self.max_slots,), np.bool_)
        spec = faults.poke("decode.nonfinite")
        if spec is not None:
            if spec.arg < 0:
                poison[:] = True
            else:
                poison[spec.arg % self.max_slots] = True
        return poison

    def _decode_dispatch(self, running: list[Request]):
        """Launch one decode step for the ``running`` slots and return the
        in-flight record.  Each sampled request draws its uniform here; the
        mirrors are copied into this step's staging buffer, so they are free
        to change once this returns."""
        with self._span("decode", device=True, batch=len(running)):
            for req in running:
                self.uniforms[req.slot] = draw_uniform(req.params,
                                                       req.generator)
            self.poison[:] = self._poison_mask()
            stage = self._staging[self.n_decode_steps % 2]
            for name, host in stage.arrays.items():
                np.copyto(host, getattr(self, name))
            if self.graph_off is None:
                if self._graph is None:
                    self._graph = _DecodeGraph(self)
                out, done = self._graph.launch(
                    stage.buffer, any(not r.params.greedy for r in running))
            else:
                v = stage.tensors
                toks, finite, _ = _decode_and_sample(
                    self.params, self.pools, v["block_tables"], v["lengths"],
                    v["next_tok"], v["temps"], v["topks"], v["topps"],
                    v["uniforms"], v["poison"], model=self.model,
                    cfg=self.cfg)
                out, done = torch.stack([finite.long(), toks]), None
            self.n_decode_steps += 1
            return {"running": running, "out": out, "done": done}

    def _decode_consume(self, inflight):
        """Wait for a dispatched step (the step's one sync) and apply it:
        a slot whose logits are not finite fails with ``ERROR`` (no re-run;
        ``guard_trips`` counts the step under ``guard=True``); every other
        slot caches its input token and takes its new one."""
        with self._span("decode.consume", batch=len(inflight["running"])):
            if inflight["done"] is not None:
                inflight["done"].synchronize()
            finite, toks = inflight["out"].tolist()
            bad = [r for r in inflight["running"] if not finite[r.slot]]
            if bad and self.numerics_config.guard:
                self._stats["guard_trips"] += 1
            for req in inflight["running"]:
                if not finite[req.slot]:
                    self._stats["numerics_errors"] += 1
                    self._finish(req, FinishReason.ERROR)
                    continue
                self.lengths[req.slot] += 1  # its input token is now cached
                self._accept_token(req, int(toks[req.slot]))

    def _on_decode_failure(self, running: list[Request], exc: Exception):
        """A decode step raised.  Under ``guard=True`` every request of the
        step finishes with ``ERROR`` (counted in ``decode_faults``) and the
        engine goes on serving the queue; otherwise the error propagates.
        Nothing re-runs the step on another path."""
        if not self.numerics_config.guard:
            raise exc
        self._stats["decode_faults"] += 1
        tr = _current_tracer()
        if tr is not None:
            tr.instant("decode-fault", cat="engine", error=repr(exc),
                       slots=[r.slot for r in running])
        for req in running:
            if req.slot is not None:
                self._finish(req, FinishReason.ERROR)

    # ------------------------------------------------------------- drive

    def _expire_deadlines(self):
        """Time out requests (running or queued) whose deadline tick has
        passed.  Runs at the top of every step, so a timed-out request
        never takes another prefill or decode."""
        for req in list(self.sched.running.values()):
            if req.deadline is not None and self.clock > req.deadline:
                self._stats["timeouts"] += 1
                self._finish(req, FinishReason.TIMEOUT)
        for req in [r for r in
                    list(self.sched.waiting) + list(self.sched.parked)
                    if r.deadline is not None and self.clock > r.deadline]:
            self._stats["timeouts"] += 1
            req.finish_reason = FinishReason.TIMEOUT.value
            self.sched.drop(req)
            self._trace_request_end(req)

    def _land_inflight(self):
        """Consume the decode step in flight, if any; a failure ends only
        the requests of that step (under ``guard=True``)."""
        if self._inflight is None:
            return
        inflight, self._inflight = self._inflight, None
        try:
            self._decode_consume(inflight)
        except Exception as exc:    # re-raised unless guard=True
            self._on_decode_failure(inflight["running"], exc)

    def _mesh_scope(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.parallel import ctx
        return ctx.use_mesh(self.mesh)

    @torch.no_grad()
    def step(self):
        """One engine iteration: consume the decode step left in flight
        (async scheduling), tick the deadline clock, expire deadlines,
        admit and prefill, advance each chunked prefill by one chunk, grow
        pages, then dispatch one decode step for every running slot: its
        consume follows at once, or at the top of the next step with
        ``async_sched``."""
        with self._span("engine.step") as sp, self._mesh_scope():
            self._land_inflight()
            self.clock += 1
            spec = faults.poke("decode.slow")
            if spec is not None:         # injected slowdown: burn ticks
                self.clock += max(1, spec.arg)
            self._expire_deadlines()
            self._admit_and_prefill()
            self._prefill_chunk_step()
            self._ensure_pages()
            running = [r for r in self.sched.running.values()
                       if r.state is RequestState.RUNNING]
            if running:
                try:
                    self._inflight = self._decode_dispatch(running)
                except Exception as exc:    # re-raised unless guard=True
                    self._on_decode_failure(running, exc)
                if not self.async_sched:
                    self._land_inflight()
            # annotated at exit: the span's args dict is live until then
            sp["clock"] = self.clock
            sp["occupancy"] = len(self.sched.running)
            sp["waiting"] = len(self.sched.waiting)

    def run(self, prompts=None, params=None) -> dict[int, RequestResult]:
        """Optionally enqueue ``prompts`` (with one :class:`SamplingParams`
        each, or one shared), run to drain, and return :meth:`results`."""
        if prompts is not None:
            if params is None or isinstance(params, SamplingParams):
                params = [params] * len(prompts)
            for prompt, sp in zip(prompts, params):
                self.add_request(prompt, sp)
        while self.sched.has_work or self._inflight is not None:
            self.step()
        return self.results()

    def results(self) -> dict[int, RequestResult]:
        return {rid: RequestResult(req.out, req.finish_reason)
                for rid, req in self._requests.items()}

    def stats(self) -> dict:
        """Resilience and throughput counters, JAX's keys: guard trips (decode steps with a non-finite slot
        under ``guard=True``), ``fallback_reruns`` (always 0: the port
        never re-runs a step on a fallback path), numerics errors,
        rejections, overloads, timeouts, length caps, prefill faults, the
        prefix cache's hits, reused tokens, copy-on-write splits and
        evictions, the clock, prefills, prefill chunks, decode steps,
        preemptions, parks, and the circuit
        breaker's global totals (``breaker``); the port's
        ``decode_faults`` (decode steps that raised under ``guard=True``);
        on ``cuda`` also the decode program's: its eager warm-up steps,
        its capture time and its replays (all of them, and of the sampler
        graph); ``decode_graph`` (whether decode replays a graph) and
        ``decode_graph_reason`` (why not: ``"cpu"``, or ``"gloo"`` under a
        mesh over gloo; None when it does)."""
        g = self._graph
        return {**self._stats,
                "decode_graph": self.graph_off is None,
                "decode_graph_reason": self.graph_off,
                "clock": self.clock,
                "prefills": self.n_prefills,
                "prefill_chunks": self.n_prefill_chunks,
                "decode_steps": self.n_decode_steps,
                "preemptions": self.sched.n_preemptions,
                "parks": self.sched.n_parks,
                "breaker": guard.counters(),
                "decode_warmups": 0 if g is None else 1,
                "capture_s": 0.0 if g is None else g.capture_s,
                "graph_replays": 0 if g is None else g.replays,
                "sampler_replays": 0 if g is None else g.sampler_replays}

    @torch.no_grad()
    def defragment(self):
        """Compact the live pages onto the low end of the pool: the device
        pools are permuted in place (the decode graph keeps its storage)
        and every running request's pages, block table and prefix-cache
        node follow.  A decode step in flight is landed first.  Safe
        between steps; the tokens do not change."""
        self._land_inflight()
        mapping = self.pool.defrag()
        permute_pages(self.pools, inverse_permutation(
            mapping, self.pool.num_pages, self.device))
        if self.prefix is not None:
            self.prefix.remap(mapping)
        for req in self.sched.running.values():
            req.pages = [mapping[p] for p in req.pages]
            if req.state is RequestState.RUNNING:
                # PREFILLING slots keep zeroed (masked) block tables
                self.block_tables[req.slot] = 0
                self.block_tables[req.slot, :len(req.pages)] = req.pages


def _mesh_backend(mesh) -> str:
    import torch.distributed as dist
    return dist.get_backend(mesh.get_group(0))


def _whole(x):
    """Logits whole on every rank (every rank samples the same tokens)."""
    from repro_torch.parallel import ctx
    return ctx.full(x)


def _decode_step(params, pools, block_tables, lengths, toks, poison, *,
                 model, cfg):
    """The model half of :func:`_decode_and_sample`: the paged decode
    (each slot's K/V written into its page in place), the logits sliced to
    the vocabulary in f32 and NaN where ``poison`` is set (the
    ``decode.nonfinite`` fault: ``torch.where(mask, nan, logits)``, bitwise
    the logits where it is not), the per-slot ``isfinite`` guard bit and
    the greedy argmax.  Returns ``(logits, finite, greedy)``."""
    logits = _whole(model.decode_step_paged(params, pools, block_tables,
                                            lengths, toks))
    logits = logits[:, :cfg.vocab_size].float()
    logits = torch.where(poison[:, None], float("nan"), logits)
    return logits, torch.isfinite(logits).all(dim=-1), torch.argmax(logits,
                                                                     dim=-1)


def _decode_and_sample(params, pools, block_tables, lengths, toks, temps,
                       topks, topps, uniforms, poison, *, model, cfg):
    """The engine step: paged model decode and vectorized sampling for
    the whole slot array (the JAX engine's jitted step; the pools are
    updated in place rather than returned).

    Returns ``(tokens, finite, logits)``: ``finite`` is the per-slot guard
    bit; False means the slot's logits hold a non-finite value and its
    token must not be trusted.  The CPU engine runs this eagerly; on
    ``cuda`` :class:`_DecodeGraph` replays it."""
    logits, finite, _ = _decode_step(params, pools, block_tables, lengths,
                                     toks, poison, model=model, cfg=cfg)
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
    raises; there is no eager fallback.  An error raised while capturing
    (a kernel failure, an injected ``kernel.*`` fault) leaves the graph
    object unfinished: the engine keeps no reference to it, so the next
    decode step warms up and captures afresh and a half-captured graph is
    never replayed.

    The kernels' Python wrappers run only at capture, so their launch
    counters see nothing of a replay: the increase each counter showed
    during capture (``launches``, kernel 3's ``f32_launches`` and kernel
    1's ``folded_launches`` and ``epilogue_launches``) is
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
        self._counters = ((tcec_matmul, "launches"),
                          (tcec_matmul, "folded_launches"),
                          (tcec_attention, "launches"),
                          (tcec_paged_attention, "launches"),
                          (tcec_paged_attention, "f32_launches"))

        def main():
            logits, finite, greedy = _decode_step(
                engine.params, engine.pools, v["block_tables"],
                v["lengths"], v["next_tok"], v["poison"],
                model=engine.model, cfg=engine.cfg)
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
        before = [getattr(m, a) for m, a in self._counters]
        epilogues = dict(tcec_matmul.epilogue_launches)
        self.main = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.main):
                self.logits = main()
        finally:
            # the capture launched nothing, whether it ended or raised
            self.per_replay = [getattr(m, a) - n for (m, a), n
                               in zip(self._counters, before)]
            for (m, a), n in zip(self._counters, before):
                setattr(m, a, n)
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
        for (m, a), n in zip(self._counters, self.per_replay):
            setattr(m, a, getattr(m, a) + n)
        for k, n in self.epilogues_per_replay.items():
            tcec_matmul.epilogue_launches[k] += n
        return self.host_out, self.done
