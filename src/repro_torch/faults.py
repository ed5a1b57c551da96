"""repro_torch.faults — context-scoped, seed-deterministic fault injection.

The JAX package's fault injection, in the port: every failure mode the
serving stack has to survive is injectable on demand and deterministically,
at named sites instrumented through the stack.  What each site does here:

=====================  ====================================================
site                   effect at the instrumented callsite in the port
=====================  ====================================================
``pool.alloc``         ``PagePool.alloc`` reports exhaustion (returns None)
``kernel.matmul``      kernel 1's guarded launch raises ``FaultInjected``
                       (``kernels/dispatch.py::_guarded``)
``kernel.attention``   kernel 2's guarded launch raises
``kernel.paged``       kernel 3's guarded launch raises
``decode.nonfinite``   the engine poisons one slot's decode logits to NaN
                       (``arg`` = slot, -1 = every slot); the slot then
                       fails with ``ERROR``: the port does not re-run the
                       step on a fallback path
``decode.slow``        an engine step burns extra deadline ticks
``prefill``            an engine prefill raises (the group is re-queued)
``prefill.chunk``      one chunk of a chunked prefill raises (the request
                       is re-queued; three failures finish it with
                       ``ERROR``)
``prefix.lookup``      a prefix-cache lookup reports a miss (a full
                       prefill, with the same tokens)
``tuning.cache``       an autotuner cache read returns a corrupt entry,
                       which reads as a miss
=====================  ====================================================

A ``kernel.*`` fault raises before the launch, inside the guarded call: the
guard (``kernels/guard.py``) counts it and re-raises it, as it does a real
kernel failure.  Nothing is rerouted to a plain path.

Usage mirrors :func:`repro_torch.numerics.use` — a thread-local, nestable
context scope::

    from repro_torch import faults
    plan = faults.FaultPlan([faults.FaultSpec("pool.alloc", at=(0, 1))])
    with faults.use(plan):
        ...   # the first two PagePool.alloc calls report exhaustion

A plan fires as a pure function of the per-site invocation index (every
instrumented callsite calls :func:`poke` exactly once per invocation,
faulting or not), so the same plan over the same workload trips the same
sequence; probabilistic specs (``p=``) draw from a stateless crc32 of
``(seed, site, index)``, the JAX package's hash, so one plan fires at the
same indices in both packages.  ``plan.log`` records every fire as
``(site, index)``.

The process-default plan parses from ``REPRO_FAULTS`` (read through
:func:`repro_torch.numerics.env_value`), e.g. ``REPRO_FAULTS="pool.alloc@0:1;
decode.slow@every=4"``; a :func:`use` scope always wins over it.  With no
active plan every ``poke`` is a cheap None.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from dataclasses import dataclass

__all__ = [
    "SITES", "FaultSpec", "FaultPlan", "FaultInjected", "active", "use",
    "poke", "raise_if", "plan_from_spec", "env_plan", "reload_env_plan",
]

# The injection-site registry, in the JAX package's order: poke() rejects
# unknown names so a typo'd site fails loudly instead of never firing.
SITES: dict[str, str] = {
    "pool.alloc": "PagePool.alloc reports exhaustion (returns None)",
    "kernel.matmul": "kernel 1's guarded launch raises FaultInjected",
    "kernel.attention": "kernel 2's guarded launch raises FaultInjected",
    "kernel.paged": "kernel 3's guarded launch raises FaultInjected",
    "decode.nonfinite": "engine poisons a slot's decode logits to NaN "
                        "(arg = slot index, -1 = every slot); the slot "
                        "fails with ERROR",
    "decode.slow": "engine step burns extra deadline ticks (arg = ticks)",
    "prefill": "engine prefill raises FaultInjected (group re-queued)",
    "prefill.chunk": "one prefill chunk raises FaultInjected (request "
                     "re-queued)",
    "prefix.lookup": "prefix-cache lookup reports a miss (full prefill)",
    "tuning.cache": "autotuner cache read returns a corrupt entry",
}


class FaultInjected(RuntimeError):
    """The error an injected fault raises at raise-style sites."""


def _hash01(seed: int, site: str, index: int) -> float:
    """Stateless uniform draw in [0, 1) from (seed, site, index): the JAX
    package's crc32, so both packages fire a p-spec at the same indices."""
    h = zlib.crc32(f"{seed}/{site}/{index}".encode())
    return h / 2**32


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule: *where* (``site``) and *when* it fires.

    Triggers compose as OR over: explicit invocation indices (``at``,
    0-based), a period (``every`` — fires on indices k-1, 2k-1, ...), and
    a seeded Bernoulli (``p``).  ``times`` caps total fires (-1 =
    unlimited); ``arg`` is a site-specific payload (slot index for
    ``decode.nonfinite``, tick count for ``decode.slow``).
    """
    site: str
    at: tuple[int, ...] = ()
    every: int = 0
    times: int = -1
    p: float = 0.0
    seed: int = 0
    arg: int = -1

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {sorted(SITES)}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))

    def triggers(self, index: int) -> bool:
        """Whether this spec (budget aside) fires on invocation ``index``."""
        if index in self.at:
            return True
        if self.every > 0 and (index + 1) % self.every == 0:
            return True
        if self.p > 0.0 and _hash01(self.seed, self.site, index) < self.p:
            return True
        return False


class FaultPlan:
    """A set of :class:`FaultSpec` rules plus the runtime trip state
    (per-site invocation counters, per-spec fire budgets, the ``log`` of
    fires).  Entering a :func:`use` scope resets it, so the same workload
    under the same plan reproduces the same trip sequence."""

    def __init__(self, specs=()):
        self.specs: tuple[FaultSpec, ...] = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs)
        self.reset()

    def reset(self) -> "FaultPlan":
        self._counts: dict[str, int] = {}
        self._fired: dict[int, int] = {i: 0 for i in range(len(self.specs))}
        self.log: list[tuple[str, int]] = []
        return self

    def counts(self) -> dict[str, int]:
        """Per-site invocation counters (faulting or not)."""
        return dict(self._counts)

    def poke(self, site: str) -> FaultSpec | None:
        """Advance ``site``'s invocation counter; return the firing spec
        (first match with budget left) or None."""
        if site not in SITES:
            raise KeyError(f"unknown fault site {site!r}; "
                           f"known: {sorted(SITES)}")
        index = self._counts.get(site, 0)
        self._counts[site] = index + 1
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if spec.times >= 0 and self._fired[i] >= spec.times:
                continue
            if spec.triggers(index):
                self._fired[i] += 1
                self.log.append((site, index))
                return spec
        return None


# ------------------------------------------------- context + env default

_tls = threading.local()
_ENV_PLAN: FaultPlan | None = None
_ENV_PLAN_LOADED = False
_env_lock = threading.Lock()


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def env_plan() -> FaultPlan | None:
    """The process-default plan parsed from ``REPRO_FAULTS`` (None when
    unset).  Parsed once; :func:`reload_env_plan` re-reads it."""
    global _ENV_PLAN, _ENV_PLAN_LOADED
    if not _ENV_PLAN_LOADED:
        with _env_lock:
            if not _ENV_PLAN_LOADED:
                from repro_torch import numerics
                spec = numerics.env_value("REPRO_FAULTS")
                _ENV_PLAN = plan_from_spec(spec) if spec else None
                _ENV_PLAN_LOADED = True
    return _ENV_PLAN


def reload_env_plan() -> FaultPlan | None:
    """Re-parse ``REPRO_FAULTS`` (tests; long-lived processes)."""
    global _ENV_PLAN_LOADED
    with _env_lock:
        _ENV_PLAN_LOADED = False
    return env_plan()


def active() -> FaultPlan | None:
    """The innermost :func:`use` plan on this thread, else the env plan."""
    stack = _stack()
    return stack[-1] if stack else env_plan()


@contextlib.contextmanager
def use(plan: FaultPlan | None = None, *specs, reset: bool = True):
    """Scoped fault plan: ``with faults.use(plan): ...``.

    Accepts a :class:`FaultPlan`, or :class:`FaultSpec` instances directly.
    ``reset=True`` (default) zeroes the plan's trip state on entry so every
    scope replays the same schedule.  ``use(None)`` masks any outer or env
    plan (a fault-free inner scope)."""
    if plan is not None and not isinstance(plan, FaultPlan):
        specs = (plan,) + specs
        plan = None
    if specs:
        plan = FaultPlan(specs)
    if plan is not None and reset:
        plan.reset()
    stack = _stack()
    stack.append(plan)
    try:
        yield plan
    finally:
        stack.pop()


def poke(site: str) -> FaultSpec | None:
    """The instrumentation hook: advance ``site``'s counter on the active
    plan and return the firing spec, or None (also when no plan is
    active)."""
    plan = active()
    if plan is None:
        return None
    return plan.poke(site)


def raise_if(site: str) -> None:
    """Raise :class:`FaultInjected` when the active plan fires ``site``."""
    if poke(site) is not None:
        raise FaultInjected(f"injected fault at {site!r}")


# ------------------------------------------------------------ env spec

def plan_from_spec(spec: str) -> FaultPlan:
    """Parse a ``REPRO_FAULTS`` string into a :class:`FaultPlan`.

    Grammar: ``;``-separated clauses, each ``site@token[:token...]``.
    A bare-integer token adds an ``at`` index; ``key=value`` tokens set
    ``every``/``times``/``p``/``seed``/``arg``.  Examples::

        pool.alloc@0:1                # first two allocs fail
        decode.slow@every=4:arg=3     # every 4th step burns 3 ticks
        kernel.matmul@p=0.25:seed=7   # seeded 25% of launches fail
    """
    out = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        site, sep, rest = clause.partition("@")
        if not sep:
            raise ValueError(f"bad fault clause {clause!r}: expected "
                             "site@trigger[:trigger...]")
        kw: dict = {"site": site.strip(), "at": []}
        for token in rest.split(":"):
            token = token.strip()
            if not token:
                continue
            key, eq, val = token.partition("=")
            if not eq:
                kw["at"].append(int(token))
            elif key in ("every", "times", "seed", "arg"):
                kw[key] = int(val)
            elif key == "p":
                kw["p"] = float(val)
            else:
                raise ValueError(f"bad fault token {token!r} in {clause!r}")
        kw["at"] = tuple(kw["at"])
        out.append(FaultSpec(**kw))
    return FaultPlan(out)
