"""kernels.guard — a circuit breaker for the kernels' launches, without a
fallback.

The JAX package's breaker, with its states, thresholds and counters.  In
JAX a kernel failure, or a call under an open breaker, returns None and the
call takes the XLA term expansion: the failure is absorbed.  **The port
never reroutes a failed or quarantined call to a plain path**: a fallback
there would hide the device and the kernel behind a plain-PyTorch result,
which the port's rules forbid (no PR replaces a hand-written kernel by
plain PyTorch, not even at run time).  So under ``guard=True``
(``NumericsConfig.guard`` / ``REPRO_GUARD``; the port's default is False):

* a kernel failure is counted (:func:`failure`) and **re-raised**;
* a call while the key's breaker is open raises :class:`KernelQuarantined`
  (naming the key and the last error) **without launching**, so a shape
  known to fail costs an exception, not a launch;
* after the cooldown, the half-open probe launches the kernel again:
  success closes the breaker, failure reopens it.

The guard makes repeated failures cheap and visible; what survives them is
the caller's business (the serving engine finishes the affected requests
with ``ERROR`` and goes on serving).  With ``guard=False`` the breaker is
not consulted and errors propagate as they are.

Breaker keys are ``(device type, kernel, *ident)``, ``ident`` the call's
``(policy, *shape bucket)``, so one pathological shape does not quarantine
the kernel wholesale.  The states:

* **closed** (healthy) — calls launch; consecutive failures are counted;
* **open** (quarantined) — after ``THRESHOLD`` consecutive failures
  :func:`allow` declines the next ``COOLDOWN`` calls;
* **half-open** (probing) — after the cooldown one call is allowed.

The cooldown is counted in calls, not wall-clock time, so transitions are a
pure function of the call sequence.  The port's dispatch runs on every
eager call (JAX's once per trace), and a CUDA graph replay runs no Python:
the engine's decode graph consults the breaker only while it is captured.

State is process-global and thread-safe; :func:`reset` restores a clean
slate for tests.
"""
from __future__ import annotations

import threading

__all__ = ["THRESHOLD", "COOLDOWN", "KernelQuarantined", "make_key",
           "allow", "quarantined", "success", "failure", "state", "stats",
           "counters", "reset", "configure"]

# Consecutive failures that open a breaker, and how many declined calls
# an open breaker sits out before probing again (JAX's values).
THRESHOLD = 2
COOLDOWN = 8

_lock = threading.Lock()


class KernelQuarantined(RuntimeError):
    """A call whose breaker is open: nothing was launched."""


class _Breaker:
    __slots__ = ("state", "consecutive_failures", "cooldown_left",
                 "failures", "successes", "declined", "opens", "closes",
                 "last_error")

    def __init__(self):
        self.state = "closed"
        self.consecutive_failures = 0
        self.cooldown_left = 0
        self.failures = 0
        self.successes = 0
        self.declined = 0
        self.opens = 0
        self.closes = 0
        self.last_error = None


_breakers: dict[tuple, _Breaker] = {}

# Process-wide health counters, aggregated over all keys.
_totals = {"allowed": 0, "declined": 0, "failures": 0, "successes": 0,
           "opens": 0, "closes": 0, "half_opens": 0}


def configure(*, threshold: int | None = None,
              cooldown: int | None = None) -> None:
    """Adjust breaker parameters (tests; ops tuning).  Global."""
    global THRESHOLD, COOLDOWN
    with _lock:
        if threshold is not None:
            if threshold < 1:
                raise ValueError("threshold must be >= 1")
            THRESHOLD = threshold
        if cooldown is not None:
            if cooldown < 1:
                raise ValueError("cooldown must be >= 1")
            COOLDOWN = cooldown


def make_key(kernel: str, ident: tuple, device) -> tuple:
    """Breaker key: ``(device type, kernel, *ident)``; ``device`` is a
    ``torch.device`` or its type's name."""
    return (getattr(device, "type", device), kernel) + tuple(ident)


def _get(key: tuple) -> _Breaker:
    b = _breakers.get(key)
    if b is None:
        b = _breakers.setdefault(key, _Breaker())
    return b


def allow(key: tuple) -> bool:
    """Gate a launch.  False = quarantined: the caller raises
    :class:`KernelQuarantined` without launching (and reports neither
    success nor failure for this call)."""
    with _lock:
        b = _get(key)
        if b.state == "open":
            if b.cooldown_left > 0:
                b.cooldown_left -= 1
                b.declined += 1
                _totals["declined"] += 1
                return False
            b.state = "half_open"
            _totals["half_opens"] += 1
        _totals["allowed"] += 1
        return True


def quarantined(key: tuple) -> KernelQuarantined:
    """The error for a call that :func:`allow` declined."""
    with _lock:
        b = _get(key)
        return KernelQuarantined(
            f"{'/'.join(str(k) for k in key)}: breaker open after "
            f"{b.consecutive_failures} consecutive failures "
            f"({b.cooldown_left} declined calls left); last error: "
            f"{b.last_error}")


def success(key: tuple) -> None:
    """Report a successful kernel call for ``key``."""
    with _lock:
        b = _get(key)
        b.successes += 1
        b.consecutive_failures = 0
        _totals["successes"] += 1
        if b.state != "closed":
            b.state = "closed"
            b.closes += 1
            _totals["closes"] += 1


def failure(key: tuple, exc: BaseException | None = None) -> None:
    """Report a failed kernel call for ``key``; may open the breaker."""
    with _lock:
        b = _get(key)
        b.failures += 1
        b.consecutive_failures += 1
        b.last_error = repr(exc) if exc is not None else None
        _totals["failures"] += 1
        # a half-open probe failure reopens immediately; a closed breaker
        # opens once consecutive failures reach the threshold
        if b.state == "half_open" or b.consecutive_failures >= THRESHOLD:
            b.state = "open"
            b.cooldown_left = COOLDOWN
            b.opens += 1
            _totals["opens"] += 1


def state(key: tuple) -> str:
    """"closed" | "open" | "half_open" (unknown keys are closed)."""
    with _lock:
        b = _breakers.get(key)
        return b.state if b is not None else "closed"


def stats() -> dict:
    """Health snapshot: global totals plus per-key detail for every key
    that has seen a failure or a decline."""
    with _lock:
        keys = {}
        for key, b in _breakers.items():
            if b.failures or b.declined or b.state != "closed":
                keys["/".join(str(k) for k in key)] = {
                    "state": b.state,
                    "failures": b.failures,
                    "successes": b.successes,
                    "declined": b.declined,
                    "opens": b.opens,
                    "closes": b.closes,
                    "last_error": b.last_error,
                }
        return {"totals": dict(_totals), "threshold": THRESHOLD,
                "cooldown": COOLDOWN, "keys": keys}


def counters() -> dict:
    """Just the global totals (the engine's ``stats()`` carries these)."""
    with _lock:
        return dict(_totals)


def reset() -> None:
    """Drop all breaker state and zero the totals (tests)."""
    with _lock:
        _breakers.clear()
        for k in _totals:
            _totals[k] = 0
