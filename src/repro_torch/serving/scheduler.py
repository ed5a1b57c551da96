"""Continuous-batching scheduler: FIFO admission, page budget, preemption.

The scheduler owns the policy half of the serving engine (which waiting
request is admitted into which slot, when a running request may grow by a
page, who is evicted when the pool runs dry); the engine owns the device
arrays and calls in here.  The rules are the JAX package's:

  * admission is strict FIFO — if the head of the queue doesn't fit (no
    free slot, or not enough pages for its prompt plus one growth page),
    nothing behind it is admitted either;
  * preemption evicts the most recently admitted running request: its
    pages are freed and it goes back to the front of the queue with its
    generated tokens intact, to be re-prefilled on re-admission
    (recompute-style; no page swapping);
  * preemption-storm parking: a request evicted ``max_preemptions`` times
    is parked instead of requeued — it sits out until the waiting queue
    drains, then rejoins at the front.  Recompute-style preemption
    re-prefills the victim's whole sequence, so a thrashing mix can burn
    most of its steps re-prefilling; parking turns that storm into
    queueing delay;
  * the prefix cache and chunked prefill (JAX's rules): the engine may
    plan an admission onto the chunked path (``admit(plan)``), where it
    maps shared prefix pages, starts in state ``PREFILLING`` and takes
    its pages chunk by chunk (:meth:`Scheduler.reserve`); a dry pool asks
    the engine's ``evict_cb`` to evict cached pages once before it blocks
    an admission or preempts.  A released request's chunked progress is
    dropped, so a re-admission replans.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from enum import Enum

from .errors import SchedulerInvariantError
from .kv_cache import PagePool
from .sampling import SamplingParams


class RequestState(Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"      # admitted, prompt prefilling in chunks
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class Request:
    """One serving request plus its runtime bookkeeping."""
    rid: int
    prompt: list[int]
    params: SamplingParams
    state: RequestState = RequestState.WAITING
    out: list[int] = field(default_factory=list)
    slot: int | None = None
    pages: list[int] = field(default_factory=list)
    n_preemptions: int = 0
    generator: object = None           # per-request torch.Generator
    finish_reason: str | None = None   # serving.errors.FinishReason value
    deadline: int | None = None        # engine-clock tick to finish by
    n_prefill_faults: int = 0          # failed prefill attempts (engine)
    t_enqueue: float | None = None     # tracer clock at add (repro_torch.obs)
    t_last_token: float | None = None  # tracer clock at last accept
    prefill_done: int = 0              # tokens prefilled so far (chunked)
    scratch: object = None             # per-request dense scratch cache
    shared_pages: int = 0              # head pages mapped from the cache

    @property
    def full_sequence(self) -> list[int]:
        """Prompt plus everything generated so far — what a re-admission
        after preemption must prefill."""
        return list(self.prompt) + list(self.out)

    @property
    def finished(self) -> bool:
        return self.state is RequestState.FINISHED


class Scheduler:
    """FIFO admission + LIFO preemption over a :class:`PagePool`."""

    def __init__(self, pool: PagePool, max_slots: int,
                 max_preemptions: int | None = None):
        self.pool = pool
        self.max_slots = max_slots
        self.max_preemptions = max_preemptions         # None = never park
        self.waiting: deque[Request] = deque()
        self.parked: deque[Request] = deque()          # storm victims
        self.running: dict[int, Request] = {}          # slot -> request
        self._ids = itertools.count()
        self._admit_seq = itertools.count()
        self._admitted_at: dict[int, int] = {}         # rid -> seq
        self.n_preemptions = 0                         # total evictions
        self.n_parks = 0                               # storm detections
        # the engine's prefix-cache eviction hook: called with a page
        # shortfall when the pool is dry, returns the pages it freed
        self.evict_cb = None

    def add(self, prompt, params: SamplingParams | None = None) -> Request:
        req = Request(rid=next(self._ids), prompt=[int(t) for t in prompt],
                      params=params or SamplingParams())
        self.waiting.append(req)
        return req

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.parked or self.running)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.max_slots) if s not in self.running]

    def admitted_at(self, req: Request) -> int:
        return self._admitted_at[req.rid]

    def _alloc(self, n: int) -> list[int] | None:
        """``pool.alloc`` with one prefix-cache eviction retry when the
        pool is dry and the engine installed ``evict_cb``; without it,
        exactly one ``pool.alloc`` (fault schedules are unchanged)."""
        pages = self.pool.alloc(n)
        if pages is None and self.evict_cb is not None:
            if self.evict_cb(max(1, n - self.pool.num_free)):
                pages = self.pool.alloc(n)
        return pages

    def admit(self, plan=None) -> list[Request]:
        """Admit waiting requests FIFO while a slot and pages are available
        (prompt pages plus one page of headroom each), as ``RUNNING``.
        Parked requests rejoin at the head once the waiting queue has
        drained.

        ``plan`` (the engine's) may send a request onto the chunked /
        shared-prefix path: it returns None for the single-shot route, or
        ``(shared_pages, start_tokens, reserve_pages)``: the cached pages
        mapped at the head of the block table (one :meth:`PagePool.share`
        each), the token prefill resumes from, and the pages to allocate
        now.  Such an admission enters ``PREFILLING``."""
        if self.parked and not self.waiting:
            self.waiting.extendleft(reversed(self.parked))
            self.parked.clear()
        admitted = []
        slots = self.free_slots()
        while self.waiting and slots:
            req = self.waiting[0]
            decision = plan(req) if plan is not None else None
            if decision is None:
                pages = self._alloc(
                    self.pool.pages_for(len(req.full_sequence) + 1))
                if pages is None:
                    break                               # strict FIFO
                shared, start = [], 0
                req.state = RequestState.RUNNING
            else:
                shared, start, reserve = decision
                pages = self._alloc(reserve) if reserve else []
                if pages is None:
                    break                               # strict FIFO
                self.pool.share(shared)
                req.state = RequestState.PREFILLING
            self.waiting.popleft()
            req.pages = list(shared) + pages
            req.shared_pages = len(shared)
            req.prefill_done = start
            req.slot = slots.pop(0)
            self.running[req.slot] = req
            self._admitted_at[req.rid] = next(self._admit_seq)
            admitted.append(req)
        return admitted

    def reserve(self, req: Request, n: int) -> list[int] | None:
        """Grant ``req`` ``n`` more pages for its next prefill chunk (no
        preemption here: the engine handles a dry pool mid-prefill);
        appended to ``req.pages``."""
        pages = self._alloc(n)
        if pages is not None:
            req.pages.extend(pages)
        return pages

    def grow(self, req: Request) -> bool:
        """Grant ``req`` one more page, preempting younger requests until it
        fits.  False only when ``req`` is alone and the pool is still dry."""
        while True:
            pages = self._alloc(1)
            if pages is not None:
                req.pages.extend(pages)
                return True
            victim = self._youngest_running(exclude=req)
            if victim is None:
                return False
            self.preempt(victim)

    def _youngest_running(self, exclude: Request) -> Request | None:
        cands = [r for r in self.running.values() if r is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda r: self._admitted_at[r.rid])

    def _release(self, req: Request, verb: str) -> None:
        if req.slot not in self.running or self.running[req.slot] is not req:
            raise SchedulerInvariantError(
                f"{verb} of request {req.rid} which is not resident in "
                f"slot {req.slot}")
        del self.running[req.slot]
        self.pool.free(req.pages)
        req.pages = []
        req.slot = None
        # chunked progress does not survive: a re-admission replans
        req.prefill_done = 0
        req.scratch = None
        req.shared_pages = 0

    def preempt(self, req: Request) -> None:
        """Evict a running request back to the front of the queue, or park
        it once it has been evicted ``max_preemptions`` times."""
        self._release(req, "preempt")
        req.state = RequestState.WAITING
        req.n_preemptions += 1
        self.n_preemptions += 1
        if (self.max_preemptions is not None
                and req.n_preemptions >= self.max_preemptions):
            self.n_parks += 1
            self.parked.append(req)
        else:
            self.waiting.appendleft(req)

    def unadmit(self, req: Request) -> None:
        """Roll an admission back (its prefill failed before any state
        landed): free pages and slot, requeue at the front.  Not an
        eviction: it does not count toward parking."""
        self._release(req, "unadmit")
        req.state = RequestState.WAITING
        self.waiting.appendleft(req)

    def finish(self, req: Request) -> None:
        """Release a completed request's slot and pages."""
        self._release(req, "finish")
        req.state = RequestState.FINISHED

    def drop(self, req: Request) -> None:
        """Finish a request that is still queued (waiting or parked):
        deadline expiry, length cap."""
        if req in self.waiting:
            self.waiting.remove(req)
        elif req in self.parked:
            self.parked.remove(req)
        else:
            raise SchedulerInvariantError(
                f"drop of request {req.rid} which is not queued")
        req.state = RequestState.FINISHED
