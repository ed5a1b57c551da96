"""The clients of a serving cell: drive ``Engine.add_request`` and
``Engine.step`` with a mix's schedule and time every token on the client's
side, at the return of the ``step()`` that produced it.

Closed loop: each client sends its next request as soon as its last one
finished (seen at a step's return).  Open loop: a request is sent once its
due time has come, whatever is still running; how late it was sent is the
generator's lag, and its time to first token counts from when it was due.

The traffic starts at ``t_start``; the first window opens at the first step
boundary ``warmup_s`` later and closes at the first step boundary its
seconds after it opened; a further window (the profiled one of a traced
run) opens right after.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


def outputs(engine):
    """``rid -> (tokens, finish_reason)`` as of now, read from the
    engine's own request records (``_requests``, each with ``out`` and
    ``finish_reason``).  The engine has no public accessor of one
    request; ``results()`` copies every request's tokens, a cost that
    would grow through the window."""
    reqs = engine._requests
    return lambda rid: (reqs[rid].out, reqs[rid].finish_reason)


@dataclass
class Sent:
    rid: int
    index: int                  # position in the schedule
    prompt_len: int
    max_tokens: int
    due: float                  # when it was due: open loop its schedule
    sent: float                 # when add_request returned
    times: list = field(default_factory=list)   # one a token
    finish: str | None = None
    finished_at: float | None = None
    tokens: list | None = None


@dataclass
class StepRec:
    end: float                  # the step's return
    decode_rows: list           # attended keys of each decode row
    prefilled: list             # prompt lengths whose first token came here


class ServeLoop:
    def __init__(self, engine, schedule, clock=time.perf_counter,
                 sleep=time.sleep):
        self.engine = engine
        self.sched = schedule
        self.mix = schedule.mix
        self.clock, self.sleep = clock, sleep
        self.sent: dict[int, Sent] = {}
        self.active: dict[int, Sent] = {}
        self.steps: list[StepRec] = []
        self.next_index = 0
        self.add_failures = 0

    # ---------------------------------------------------------- sending

    def _send(self, now: float, due: float) -> None:
        if self.next_index >= len(self.sched.requests):
            raise RuntimeError("the schedule ran out of requests: raise the "
                               "mix's 'requests'")
        from repro_torch.serving import SamplingParams
        req = self.sched.requests[self.next_index]
        try:
            rid = self.engine.add_request(
                req.prompt, SamplingParams(max_tokens=req.max_tokens))
        except Exception:           # a refused request counts as failed
            self.add_failures += 1
            self.next_index += 1
            return
        s = Sent(rid, self.next_index, len(req.prompt), req.max_tokens,
                 due=due, sent=self.clock())
        self.next_index += 1
        self.sent[rid] = s
        self.active[rid] = s

    def _send_due(self, t0: float) -> None:
        """Open loop: send every request whose time has come."""
        now = self.clock()
        reqs = self.sched.requests
        while (self.next_index < len(reqs)
               and t0 + reqs[self.next_index].due <= now):
            self._send(now, t0 + reqs[self.next_index].due)

    # ------------------------------------------------------------ a step

    def _step(self) -> None:
        self.engine.step()
        now = self.clock()
        results = outputs(self.engine)
        rows, prefilled, done = [], [], []
        for rid, s in self.active.items():
            tokens, finish = results(rid)
            n_old, n_new = len(s.times), len(tokens)
            if n_new > n_old:
                s.times.extend([now] * (n_new - n_old))
                first = 0
                if n_old == 0:
                    prefilled.append(s.prompt_len)
                    first = 1
                # decode rows: token j (0-based, j >= 1) was predicted at
                # position prompt_len + j - 1, attending prompt_len + j keys
                rows.extend(s.prompt_len + j
                            for j in range(max(n_old, first), n_new))
            if finish is not None:
                s.finish = finish
                s.finished_at = now
                s.tokens = [int(t) for t in tokens]
                done.append(rid)
        for rid in done:
            del self.active[rid]
        self.steps.append(StepRec(now, rows, prefilled))
        if self.mix["loop"] == "closed":
            for _ in done:
                self._send(now, now)

    # ------------------------------------------------------------- drive

    def prewarm(self, prompts: list, tokens: int = 4) -> None:
        """Serve ``prompts`` to the end before the traffic starts: the
        kernels are built or loaded, the decode graph is captured and each
        path of the prefill runs once, so no arrival waits on them."""
        from repro_torch.serving import SamplingParams
        eng = self.engine
        rids = [eng.add_request(p, SamplingParams(max_tokens=tokens))
                for p in prompts]
        for _ in range(100_000):
            out = outputs(eng)
            if all(out(r)[1] is not None for r in rids):
                return
            eng.step()
        raise RuntimeError("the warm-up requests did not finish")

    def run(self, warmup_s: float, seconds: list,
            on_edge=None) -> list:
        """Run the traffic through back-to-back windows of ``seconds``
        (a list); returns each window's ``(t_open, t_close)``.
        ``on_edge(i)`` runs at edge ``i``, outside the windows' time: 0
        before the first window opens, ``i`` after window ``i`` closed
        (and before the next opens)."""
        open_loop = self.mix["loop"] == "open"
        t0 = self.clock()
        if not open_loop:
            for _ in range(self.mix["clients"]):
                self._send(t0, t0)
        windows, t_open = [], None
        while True:
            now = self.clock()
            if t_open is None and now >= t0 + warmup_s:
                if on_edge is not None:
                    on_edge(0)
                t_open = self.clock()
            elif t_open is not None and now >= t_open + seconds[len(windows)]:
                windows.append((t_open, now))
                if on_edge is not None:
                    on_edge(len(windows))
                if len(windows) == len(seconds):
                    return windows
                t_open = self.clock()
            if open_loop:
                self._send_due(t0)
                if not self.active and self.next_index < len(
                        self.sched.requests):
                    wait = (t0 + self.sched.requests[self.next_index].due
                            - self.clock())
                    if wait > 0:
                        self.sleep(min(wait, 0.05))
                    continue
            self._step()
