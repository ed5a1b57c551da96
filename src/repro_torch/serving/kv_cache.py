"""Paged KV-cache pool: fixed-size pages, per-sequence block tables.

A request holds ``ceil(len / page_size)`` pages of a pool shared by every
in-flight request, listed in its block-table row, and frees them the
moment it completes (the vLLM PagedAttention memory model).

  * :class:`PagePool` — the host-side allocator (free-list and refcount
    bookkeeping, no device arrays).  Page 0 is the scrap page: inactive
    engine slots point their block tables at it, so their masked decode
    writes land somewhere harmless.
  * the device page arrays live in the model's cache tree
    (``models.lm.init_paged_cache``).  Every helper below writes them in
    place: the engine's decode graph is captured over their storage, so
    no helper may rebind a pool tensor.  :func:`write_prompt_pages`
    scatters a sequence-level prefill's K/V into freshly allocated pages,
    :func:`write_span_pages` one chunk's span from a chunked prefill's
    scratch, :func:`load_pages_into_scratch` gathers cached prefix pages
    into a scratch, and :func:`permute_pages` applies a defrag
    permutation.
"""
from __future__ import annotations

import torch

from repro_torch import faults
from repro_torch.models.modules import tree_leaves
from repro_torch.parallel import ctx
from .errors import PagePoolError

DEFAULT_PAGE_SIZE = 16


class PagePool:
    """Host-side page allocator over ``num_pages`` fixed-size pages.

    LIFO free list: recently freed pages are reused first.  ``alloc`` is
    all-or-nothing — a partial grant would deadlock two growing requests
    against each other.

    Pages are refcounted so the prefix cache can share them across
    requests (and hold its own reference): ``alloc`` hands out pages at
    refcount 1, :meth:`share` adds owners, and :meth:`free` returns a page
    to the free list only when its last owner lets go.
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
        self._ref: dict[int, int] = {}          # live page -> owner count

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
        for p in taken:
            self._ref[p] = 1
        return taken

    def share(self, pages: list[int]) -> None:
        """Add one owner to each page (prefix-cache sharing).  Only live
        pages can gain owners."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise PagePoolError(f"share of non-live page {p}")
        for p in pages:
            self._ref[p] += 1

    def refcount(self, p: int) -> int:
        """Current owner count of page ``p`` (0 = free)."""
        return self._ref.get(p, 0)

    def free(self, pages: list[int]) -> None:
        """Drop one owner a page; pages reaching zero owners return to the
        free list.  Freeing a page that has no owner is a double free."""
        for p in pages:
            if not 0 < p < self.num_pages:
                raise PagePoolError(f"free of out-of-range page {p} "
                                    f"(pool has {self.num_pages})")
            if self._ref.get(p, 0) < 1:
                raise PagePoolError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)

    def defrag(self) -> dict[int, int]:
        """Compact live pages onto the lowest indices.

        Returns the ``{old: new}`` mapping of live pages (identity entries
        included) and rebuilds the free list above them; refcounts travel
        with their pages.  Callers re-index their block tables and apply
        the same permutation to the device pools (:func:`permute_pages`).
        """
        live = sorted(set(range(1, self.num_pages)) - set(self._free))
        mapping = {old: new for new, old in enumerate(live, start=1)}
        self._free = list(range(self.num_pages - 1, len(live), -1))
        self._ref = {mapping[p]: c for p, c in self._ref.items()}
        return mapping


# ------------------------------------------------------- device helpers

def _local(pool):
    """The storage a write goes to: a sharded pool's local shard (the
    DTensor sees the write; see ``parallel.ctx.local_like``)."""
    return pool.to_local() if ctx.is_dtensor(pool) else pool


def _pairs(pools, other):
    """``(pool leaf, matching leaf of other)`` over the nested cache trees."""
    for name, pool in pools.items():
        if isinstance(pool, dict):
            yield from _pairs(pool, other[name])
        else:
            yield pool, other[name]


def write_prompt_pages(pools, kv, pages: torch.Tensor):
    """Scatter a sequence-level prefill's K/V into allocated pages, in place.

    pools: the ``init_paged_cache`` tree, leaves (nL, NP, ps, ...); kv: the
    matching ``prefill`` tree, leaves (nL, B, P, ...) with ``P`` a multiple
    of ``ps``; pages: (B, P // ps) page indices per sequence.
    """
    flat = pages.reshape(-1).long()
    for pool, k in _pairs(pools, kv):
        nL, B, P = k.shape[:3]
        ps = pool.shape[2]
        rows = k.reshape((nL, B * (P // ps), ps) + tuple(k.shape[3:]))
        _local(pool)[:, flat] = ctx.local_like(rows, pool).to(pool.dtype)
    return pools


def load_pages_into_scratch(scratch, pools, pages: torch.Tensor):
    """Gather cached prefix pages into the head of a per-request dense
    scratch (chunked prefill over a prefix-cache hit), in place.

    scratch: an ``init_cache(1, T)`` tree, leaves (nL, 1, T, ...); pools:
    leaves (nL, NP, ps, ...); pages: (n,) indices with ``n * ps <= T``.
    The gathered tokens land at positions ``[0, n * ps)``."""
    idx = pages.long()
    for s, pool in _pairs(scratch, pools):
        g = ctx.full(pool[:, idx])                    # (nL, n, ps, ...)
        s[:, 0, :g.shape[1] * g.shape[2]] = g.flatten(1, 2).to(s.dtype)
    return scratch


def write_span_pages(pools, scratch, start: int, pages: torch.Tensor):
    """Scatter one chunk's token span from the scratch into pages, in place.

    pools: leaves (nL, NP, ps, ...); scratch: leaves (nL, 1, T, ...);
    start: the span's first token (page-aligned); pages: (n,) indices —
    the span covers tokens ``[start, start + n * ps)``.  The f32 scratch
    values are cast to the pool dtype as :func:`write_prompt_pages` casts
    a monolithic prefill's, so both land bitwise-identical pages."""
    idx = pages.long()
    n = idx.numel()
    for pool, s in _pairs(pools, scratch):
        ps = pool.shape[2]
        span = s[:, 0, start:start + n * ps]
        span = span.reshape((span.shape[0], n, ps) + tuple(span.shape[2:]))
        _local(pool)[:, idx] = ctx.local_like(span, pool).to(pool.dtype)
    return pools


def permute_pages(pools, perm: torch.Tensor):
    """Apply a defrag permutation to the device pools in place, one layer
    at a time (the copy costs one layer's pool, not a second whole pool).

    perm: (NP,) with ``perm[new] = old`` (identity off the live set), the
    inverse of :meth:`PagePool.defrag`'s ``{old: new}`` mapping."""
    idx = perm.long()
    for pool in tree_leaves(pools):
        for layer in _local(pool):
            layer.copy_(layer[idx])
    return pools


def inverse_permutation(mapping: dict[int, int], num_pages: int,
                        device=None) -> torch.Tensor:
    """Turn defrag's ``{old: new}`` into the (NP,) gather index
    ``perm[new] = old`` that :func:`permute_pages` takes."""
    perm = list(range(num_pages))
    for old, new in mapping.items():
        perm[new] = old
    return torch.tensor(perm, dtype=torch.int64, device=device)
