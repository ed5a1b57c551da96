"""Paged KV-cache pool: fixed-size pages, per-sequence block tables.

A request holds ``ceil(len / page_size)`` pages of a pool shared by every
in-flight request, listed in its block-table row, and frees them the
moment it completes (the vLLM PagedAttention memory model).

  * :class:`PagePool` — the host-side allocator (free-list bookkeeping, no
    device arrays).  Page 0 is the scrap page: inactive engine slots point
    their block tables at it, so their masked decode writes land somewhere
    harmless.
  * the device page arrays live in the model's cache tree
    (``models.lm.init_paged_cache``); :func:`write_prompt_pages` scatters a
    sequence-level prefill's K/V into freshly allocated pages, in place.
"""
from __future__ import annotations

import torch

from repro_torch import faults
from .errors import PagePoolError

DEFAULT_PAGE_SIZE = 16


class PagePool:
    """Host-side page allocator over ``num_pages`` fixed-size pages.

    LIFO free list: recently freed pages are reused first.  ``alloc`` is
    all-or-nothing — a partial grant would deadlock two growing requests
    against each other.  (The JAX pool also refcounts pages for its prefix
    cache, which is not ported yet.)
    """

    def __init__(self, num_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if num_pages < 2:
            raise ValueError("need at least the scrap page + one real page; "
                             f"got num_pages={num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))
        self._live: set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens``."""
        return max(1, -(-n_tokens // self.page_size))

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages, or None (and no change) if they don't fit.

        The ``pool.alloc`` fault site injects transient exhaustion here
        (None with pages available): the signal every caller handles
        already."""
        if faults.poke("pool.alloc") is not None:
            return None
        if n > len(self._free):
            return None
        taken = self._free[-n:][::-1]
        del self._free[-n:]
        self._live.update(taken)
        return taken

    def free(self, pages: list[int]) -> None:
        """Return pages to the free list."""
        for p in pages:
            if not 0 < p < self.num_pages:
                raise PagePoolError(f"free of out-of-range page {p} "
                                    f"(pool has {self.num_pages})")
            if p not in self._live:
                raise PagePoolError(f"double free of page {p}")
            self._live.remove(p)
            self._free.append(p)


def write_prompt_pages(pools, kv, pages: torch.Tensor):
    """Scatter a sequence-level prefill's K/V into allocated pages, in place.

    pools: the ``init_paged_cache`` tree, leaves (nL, NP, ps, ...); kv: the
    matching ``prefill`` tree, leaves (nL, B, P, ...) with ``P`` a multiple
    of ``ps``; pages: (B, P // ps) page indices per sequence.
    """
    flat = pages.reshape(-1).long()
    for name, pool in pools.items():
        if isinstance(pool, dict):
            write_prompt_pages(pool, kv[name], pages)
            continue
        k = kv[name]
        nL, B, P = k.shape[:3]
        ps = pool.shape[2]
        pool[:, flat] = k.reshape((nL, B * (P // ps), ps) + tuple(
            k.shape[3:])).to(pool.dtype)
    return pools
