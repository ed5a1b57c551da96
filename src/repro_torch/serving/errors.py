"""Structured serving errors and the finish-reason taxonomy.

The engine distinguishes "your request was bad" (:class:`RequestRejected`),
"the server is full, retry later" (:class:`EngineOverloaded`) and
"something inside broke" (:class:`ServingError` subclasses), and every
request that runs comes back with a machine-readable statement of why it
stopped (:class:`FinishReason`).  The JAX package's taxonomy, value for
value.

Exceptions (request never produces tokens):

* :class:`RequestRejected` — the request itself can never be served
  (``max_tokens < 1``, prompt beyond the per-slot page cap, ``deadline <
  1``).  Subclasses ``ValueError``: rejection is an input-validation
  failure.
* :class:`EngineOverloaded` — the bounded waiting queue is full
  (``Engine(max_waiting=...)``); the backpressure signal.  Retryable.
* :class:`SchedulerInvariantError` / :class:`PagePoolError` — internal
  invariant violations (double free, finishing a non-resident request).
  These indicate a bug, not a bad request, and are never swallowed.

Finish reasons (request ran; ``Engine.run()`` returns them on each
:class:`RequestResult`):

=============  =========================================================
``stop``       hit one of its ``SamplingParams.stop_tokens``
``length``     generated ``max_tokens`` tokens
``length_cap`` hit the engine's per-slot page cap (server max context)
``timeout``    exceeded its per-request deadline (engine clock ticks)
``error``      non-finite logits in a decode step (the port does not
               re-run the step on a fallback path), a prefill that failed
               ``MAX_PREFILL_FAULTS`` times, a decode step that raised
               under ``guard=True``, or a pool too small for the request
=============  =========================================================

``rejected`` / ``overloaded`` complete the taxonomy for transport layers
that log exception outcomes in the same field as finish reasons; the
engine itself raises for those instead of returning a result.
"""
from __future__ import annotations

from enum import Enum

__all__ = ["FinishReason", "ServingError", "RequestRejected",
           "EngineOverloaded", "SchedulerInvariantError", "PagePoolError",
           "RequestResult"]


class FinishReason(str, Enum):
    """Why a request stopped producing tokens.  ``str``-valued so
    ``result.finish_reason == "stop"`` reads naturally at call sites."""
    STOP = "stop"
    LENGTH = "length"
    LENGTH_CAP = "length_cap"
    TIMEOUT = "timeout"
    ERROR = "error"
    # exception outcomes, for transports that log one unified field:
    REJECTED = "rejected"
    OVERLOADED = "overloaded"

    def __str__(self) -> str:          # str(reason) == "stop", not the repr
        return self.value


class ServingError(RuntimeError):
    """Base of the serving-layer error taxonomy."""


class RequestRejected(ServingError, ValueError):
    """The request can never be served as posed (invalid ``max_tokens``,
    prompt beyond the per-slot page cap).  Not retryable as-is."""


class EngineOverloaded(ServingError):
    """The bounded waiting queue is full — backpressure; retry later."""


class SchedulerInvariantError(ServingError):
    """A scheduler bookkeeping invariant was violated (engine bug)."""


class PagePoolError(ServingError):
    """A page-pool bookkeeping invariant was violated (double free,
    out-of-range page)."""


class RequestResult(list):
    """Generated tokens plus the finish reason.

    A ``list`` subclass so every existing call site — ``out[rid][:8]``,
    ``out[rid] == ref``, ``np.asarray(out[rid])`` — keeps working while
    new callers read ``out[rid].finish_reason``.
    """

    def __init__(self, tokens=(), finish_reason=None):
        super().__init__(int(t) for t in tokens)
        if isinstance(finish_reason, FinishReason):
            finish_reason = finish_reason.value
        self.finish_reason: str | None = finish_reason

    @property
    def tokens(self) -> list[int]:
        return list(self)

    def __repr__(self) -> str:
        return (f"RequestResult({list(self)!r}, "
                f"finish_reason={self.finish_reason!r})")
