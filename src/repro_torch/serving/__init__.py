"""Continuous-batching serving over the paged KV cache (engine core)."""
from .engine import Engine
from .errors import (EngineOverloaded, FinishReason, PagePoolError,
                     RequestRejected, RequestResult, SchedulerInvariantError,
                     ServingError)
from .kv_cache import DEFAULT_PAGE_SIZE, PagePool, write_prompt_pages
from .sampling import SamplingParams, sample_one
from .scheduler import Request, RequestState, Scheduler

__all__ = ["Engine", "EngineOverloaded", "FinishReason", "PagePoolError",
           "RequestRejected", "RequestResult", "SchedulerInvariantError",
           "ServingError", "DEFAULT_PAGE_SIZE", "PagePool",
           "write_prompt_pages", "SamplingParams", "sample_one", "Request",
           "RequestState", "Scheduler"]
