"""Copy-on-write prefix cache: page-granular KV sharing across requests.

The JAX package's prefix cache (``repro/serving/prefix_cache.py``), rule
for rule.  Full prompt pages are keyed by their tokens in a prefix tree, so
a request whose prompt prefix was already prefilled maps the cached pages
read-only (:meth:`PagePool.share` refcounts) and computes only the novel
tail.

  * **content-keyed tree**: each node is one full page of tokens; the path
    from the root is the whole prefix, so page ``j`` of a hit holds K/V
    computed under exactly the same preceding tokens.  Partial pages are
    never cached.
  * **copy-on-write**: requests never write shared pages.  The engine
    splits before any write into a page with ``refcount > 1``: it
    allocates a private copy, rewrites it from the prefill scratch and
    drops the shared reference.  The cache's pages are therefore immutable.
  * **LRU eviction under pressure**: the cache holds one reference a node.
    When the pool runs dry, :meth:`evict_for` frees leaf nodes (deepest
    first within a chain) in least-recently-matched order, and only pages
    no request still references.
  * **fault site** ``prefix.lookup`` (:mod:`repro_torch.faults`): an
    injected fault makes :meth:`match` report a miss, so a poisoned lookup
    degrades to a full prefill with the same tokens.

The tree is host-side bookkeeping; the pages live in the engine's pools
and move (defrag) through :meth:`remap`.
"""
from __future__ import annotations

from repro_torch import faults
from .kv_cache import PagePool


class _Node:
    """One cached full page: its pool index, LRU clock, and children keyed
    by the next page's token tuple."""

    __slots__ = ("page", "last_use", "children", "parent", "key")

    def __init__(self, page: int, parent: "_Node | None", key: tuple):
        self.page = page
        self.last_use = 0
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.key = key


class PrefixCache:
    """Prefix tree over a :class:`PagePool`'s refcounted pages.

    The cache owns one pool reference a node (taken at :meth:`insert`,
    dropped at eviction).  :meth:`match` returns pages without adding
    references: the engine shares them once it maps them into a request.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._children: dict[tuple, _Node] = {}        # root level
        self._clock = 0
        self.n_nodes = 0
        self.n_evictions = 0

    def match(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached full-page prefix of ``tokens``: ``(pages,
        matched_tokens)`` with ``matched_tokens == len(pages) *
        page_size``.  Matched nodes' LRU clocks are touched."""
        if faults.poke("prefix.lookup") is not None:
            return [], 0
        ps = self.pool.page_size
        pages: list[int] = []
        children = self._children
        self._clock += 1
        for start in range(0, len(tokens) - ps + 1, ps):
            node = children.get(tuple(tokens[start:start + ps]))
            if node is None:
                break
            node.last_use = self._clock
            pages.append(node.page)
            children = node.children
        return pages, len(pages) * ps

    def insert(self, tokens: list[int], pages: list[int]) -> int:
        """Register a prefilled sequence's full pages (``pages[j]`` holds
        the K/V of ``tokens[j*ps:(j+1)*ps]``; a trailing partial page is
        ignored).  New nodes take one pool reference each; a token block
        already cached keeps its page, and the caller's duplicate stays
        request-owned.  Returns the number of nodes created."""
        ps = self.pool.page_size
        created = 0
        children = self._children
        parent: _Node | None = None
        self._clock += 1
        for j in range(min(len(tokens) // ps, len(pages))):
            key = tuple(tokens[j * ps:(j + 1) * ps])
            node = children.get(key)
            if node is None:
                node = _Node(pages[j], parent, key)
                self.pool.share([pages[j]])
                children[key] = node
                self.n_nodes += 1
                created += 1
            node.last_use = self._clock
            children = node.children
            parent = node
        return created

    def _leaves(self) -> list[_Node]:
        out = []
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict_for(self, n: int) -> int:
        """Free up to ``n`` pages by evicting least-recently-matched leaves
        whose pages only the cache still references (evicting a leaf can
        expose its parent).  Returns the number of pages freed."""
        freed = 0
        while freed < n:
            cands = [lf for lf in self._leaves()
                     if self.pool.refcount(lf.page) == 1]
            if not cands:
                break
            victim = min(cands, key=lambda lf: (lf.last_use, -lf.page))
            siblings = (victim.parent.children if victim.parent is not None
                        else self._children)
            del siblings[victim.key]
            self.pool.free([victim.page])
            self.n_nodes -= 1
            self.n_evictions += 1
            freed += 1
        return freed

    def remap(self, mapping: dict[int, int]) -> None:
        """Apply a :meth:`PagePool.defrag` ``{old: new}`` mapping to every
        cached node."""
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            node.page = mapping[node.page]
            stack.extend(node.children.values())
