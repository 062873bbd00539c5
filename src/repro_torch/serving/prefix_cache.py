"""Shared-prefix radix KV cache (DESIGN.md §9).

Copy of ``repro/serving/prefix_cache.py`` (numpy only): a fix there must
be copied here by hand.

Production traces are dominated by multi-turn conversations and shared
system prompts: turn *k+1*'s prompt literally starts with turn *k*'s, so
re-prefilling the whole history wastes the dominant share of prefill
compute (SGLang's RadixAttention and Locality-aware Fair Scheduling,
arXiv:2501.14312, both build on this).  This module adds the sharing
layer on top of the refcounted ``PagePool``:

- a **page-granular radix tree** over prompt token ids.  Edges are whole
  KV pages (``page_size`` tokens); a node stores the page ids holding
  the KV of its edge tokens.  Only *full* pages are ever shared — a
  prompt's trailing partial page stays private to its request, which is
  the copy-on-write rule at page granularity: a new request whose prompt
  diverges (or merely ends) inside a page recomputes that page into its
  own fresh allocation instead of mutating a shared one (shared pages
  are write-never, so no actual copy is needed);
- **refcount integration**: matching a prefix ``adopt``s the pages
  (refcount +1) into the new request's block table; completed requests
  decrement; pages at refcount 0 stay warm in the tree until pool
  pressure LRU-evicts them (``PagePool.reclaimer`` hook);
- **hit accounting** consumed by the fairness counters (cache-hit input
  tokens can be charged a discounted ``omega_cached`` weight — a cached
  token costs the operator almost nothing, so charging it like a
  computed token over-bills the client; see ``core.counters``) and by
  the ``prefix_affinity`` cluster routing policy.

Both the discrete-event simulator and the real engine drive this same
class through ``BatchCore`` (lookup/attach at admission, insert when a
prompt finishes prefilling), so cache-hit admission decisions and TTFT
accounting cannot drift between the two frontends.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.kv_cache import PagePool


class RadixNode:
    """One edge of the radix tree: ``tokens`` (len = n_pages · page_size)
    and the pool pages holding their KV.  Children are keyed by their
    edge's first *page* of tokens — splits only happen at page
    boundaries, so sibling edges always differ inside their first page
    and the tuple key is unique."""

    __slots__ = ("tokens", "pages", "children", "parent", "last_access")

    def __init__(self, tokens: Tuple[int, ...], pages: List[int],
                 parent: Optional["RadixNode"], last_access: float):
        self.tokens = tokens
        self.pages = pages
        self.children: Dict[Tuple[int, ...], "RadixNode"] = {}
        self.parent = parent
        self.last_access = last_access

    @property
    def n_pages(self) -> int:
        return len(self.pages)


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hits: int = 0                 # lookups with a non-empty cached prefix
    lookup_tokens: int = 0        # prompt tokens seen by lookups
    hit_tokens: int = 0           # of those, served from the cache
    inserted_pages: int = 0
    evicted_pages: int = 0

    def hit_rate(self) -> float:
        """Token-level hit rate: cached / total prompt tokens."""
        return self.hit_tokens / max(self.lookup_tokens, 1)

    def as_dict(self) -> dict:
        return {"lookups": self.lookups, "hits": self.hits,
                "lookup_tokens": self.lookup_tokens,
                "hit_tokens": self.hit_tokens,
                "hit_rate": self.hit_rate(),
                "inserted_pages": self.inserted_pages,
                "evicted_pages": self.evicted_pages}


class PrefixCache:
    """Radix tree + refcounted page sharing over one replica's PagePool."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = RadixNode((), [], None, 0.0)
        self.stats = CacheStats()
        pool.reclaimer = self.evict

    # -- tree walk -----------------------------------------------------------
    def _walk(self, tokens: np.ndarray, touch_time: Optional[float]):
        """Longest whole-page match: returns (pages, nodes on the path).
        ``touch_time`` refreshes LRU stamps; pass None for a side-effect
        free peek (routing probes must not distort eviction order)."""
        ps = self.page_size
        toks = tuple(int(t) for t in tokens[:len(tokens) // ps * ps])
        node, i, pages, path = self.root, 0, [], []
        while i < len(toks):
            child = node.children.get(toks[i:i + ps])
            if child is None:
                break
            # whole-page compare along the child's edge
            k = 0
            while (k < child.n_pages
                   and child.tokens[k * ps:(k + 1) * ps]
                   == toks[i + k * ps:i + (k + 1) * ps]):
                k += 1
            pages.extend(child.pages[:k])
            path.append(child)
            if touch_time is not None:
                child.last_access = touch_time
            if k < child.n_pages:
                break                      # diverged inside this edge
            node, i = child, i + k * ps
        return pages, path

    def match_len(self, tokens) -> int:
        """Side-effect-free probe (cluster routing): longest cached
        page-aligned prefix of ``tokens``, in tokens."""
        if tokens is None or len(tokens) < self.page_size:
            return 0
        pages, _ = self._walk(np.asarray(tokens), None)
        return len(pages) * self.page_size

    # -- request-facing API (driven by BatchCore) ----------------------------
    def lookup(self, req, now: float) -> int:
        """Longest cached page-aligned prefix of the request's prompt,
        capped so at least the prompt's last token is always recomputed
        (its logits seed the first output token).  Stores the matched
        pages on the request for ``attach``; no refcounts move yet —
        admission can still fail and requeue."""
        toks = req.prompt_tokens
        if toks is None or req.prompt_len <= 1:
            req._cached_pages = []
            return 0
        pages, _ = self._walk(np.asarray(toks[:req.prompt_len]), now)
        cap = (req.prompt_len - 1) // self.page_size
        pages = pages[:cap]
        req._cached_pages = pages
        return len(pages) * self.page_size

    def attach(self, req, now: float):
        """Admission succeeded: share the matched pages with the request
        (refcount +1, block table prefix) and record hit stats."""
        pages = getattr(req, "_cached_pages", [])
        self.stats.lookups += 1
        self.stats.lookup_tokens += req.prompt_len
        if pages:
            self.pool.adopt(req.rid, pages)
            self.stats.hits += 1
            self.stats.hit_tokens += len(pages) * self.page_size

    def insert(self, req, now: float) -> int:
        """Prompt fully prefilled: publish its whole-page prefix into the
        tree.  Pages covering an already-cached prefix are left alone
        (the request's duplicates stay private and die with it); only the
        unmatched tail is inserted.  Returns pages newly cached."""
        toks = req.prompt_tokens
        if toks is None:
            return 0
        ps = self.page_size
        n_pages = req.prompt_len // ps
        if n_pages == 0:
            return 0
        # the simulator never allocated during chunks — make the pages real
        # (the engine's paged backend already did; ensure is a no-op there)
        try:
            pages = self.pool.ensure(req.rid, n_pages * ps)[:n_pages]
        except MemoryError:
            return 0                # pool full of live pages: skip caching
        toks = tuple(int(t) for t in toks[:n_pages * ps])

        node, i = self.root, 0
        while i < len(toks):
            key = toks[i:i + ps]
            child = node.children.get(key)
            if child is None:
                leaf = RadixNode(toks[i:], pages[i // ps:], node, now)
                node.children[key] = leaf
                self.pool.mark_cached(leaf.pages)
                self.stats.inserted_pages += len(leaf.pages)
                return len(leaf.pages)
            k = 0
            while (k < child.n_pages
                   and child.tokens[k * ps:(k + 1) * ps]
                   == toks[i + k * ps:i + (k + 1) * ps]):
                k += 1
            child.last_access = now
            if k == child.n_pages:
                node, i = child, i + k * ps
                continue
            # diverged after k full pages: split the edge at the boundary
            mid = RadixNode(child.tokens[:k * ps], child.pages[:k],
                            node, now)
            child.tokens = child.tokens[k * ps:]
            child.pages = child.pages[k:]
            child.parent = mid
            node.children[key] = mid
            mid.children[child.tokens[:ps]] = child
            rest = toks[i + k * ps:]
            if not rest:
                return 0            # new prompt is a strict prefix: no tail
            leaf = RadixNode(rest, pages[i // ps + k:], mid, now)
            mid.children[rest[:ps]] = leaf
            self.pool.mark_cached(leaf.pages)
            self.stats.inserted_pages += len(leaf.pages)
            return len(leaf.pages)
        return 0

    def release(self, req):
        """Completion: drop the request's page references (shared prefix
        refcounts decrement; cached pages stay warm in the tree)."""
        if req.rid in self.pool.owned:
            self.pool.free_request(req.rid)

    # -- eviction ------------------------------------------------------------
    def _evictable_tails(self) -> List[tuple]:
        """(leaf, keep_pages) pairs: every leaf with a refcount-0 *tail*.
        Adopters always take a prefix of a path, so within one edge the
        refcount-0 pages are a suffix — trimming the tail keeps the
        node's tokens/pages prefix-consistent and makes every cached
        refcount-0 page reclaimable (``PagePool.can_alloc`` counts them,
        so eviction must be able to reach them all)."""
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children:
                k = n.n_pages
                while k > 0 and self.pool.refcount.get(n.pages[k - 1],
                                                       0) == 0:
                    k -= 1
                if k < n.n_pages:
                    out.append((n, k))
        return out

    def evict(self, n_pages: int) -> int:
        """LRU-evict leaf tails until ``n_pages`` pages returned to the
        free list (or nothing evictable remains).  A page referenced by
        any live request (refcount > 0) is never reclaimed; a fully
        trimmed leaf is unlinked, so interior nodes become leaves — and
        evictable — in the next sweep.  Victims are collected once per
        sweep and drained in LRU order (not re-scanned per page); a new
        sweep only runs when unlinking exposed new leaves."""
        freed = 0
        while freed < n_pages:
            victims = sorted(self._evictable_tails(),
                             key=lambda v: v[0].last_access)
            if not victims:
                break
            for node, keep in victims:
                if freed >= n_pages:
                    break
                tail = node.pages[keep:]
                freed += self.pool.release_cached(tail)
                self.stats.evicted_pages += len(tail)
                if keep == 0:
                    node.parent.children.pop(
                        node.tokens[:self.page_size], None)
                    node.parent = None
                else:
                    node.pages = node.pages[:keep]
                    node.tokens = node.tokens[:keep * self.page_size]
        return freed

    # -- introspection -------------------------------------------------------
    def cached_pages(self) -> int:
        return len(self.pool.cached)

    def cached_tokens(self) -> int:
        return len(self.pool.cached) * self.page_size
