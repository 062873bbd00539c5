"""Paged KV-cache block manager (host side) + pool tensors (device side).

Port of ``repro/serving/kv_cache.py``.  ``PagePool`` is a copy of the
reference's host-side numpy allocator: requests own lists of refcounted
page ids, and block tables are dense int32 matrices handed to the
paged-attention kernels (0-padded; padding pages are masked by
``ctx_lens`` inside the kernel).  The pools are (L, n_pages, page_size,
n_kv_heads, head_dim) tensors on the device, written in place.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch


class PagePool:
    """Free-list allocator over a fixed number of refcounted pages."""

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.owned: Dict[int, List[int]] = {}
        self.refcount: Dict[int, int] = {}      # live pages only
        self.cached: Set[int] = set()           # pinned by the prefix cache
        self.adopted: Dict[int, Set[int]] = {}  # rid -> pages it adopted
        self.adopted_refs: Dict[int, int] = {}  # page -> adopter refcount
        # memoized pinned_unaccounted_pages(): the admission/preemption
        # hot path queries it per attempt, but its inputs only change on
        # adopt/free/pin/unpin — recompute lazily on those mutations
        self._pinned_memo = 0
        self._pinned_dirty = False
        # prefix-cache eviction hook: called with the number of pages still
        # missing; must return how many it actually released to the free
        # list (0 when nothing is evictable)
        self.reclaimer: Optional[Callable[[int], int]] = None

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def evictable_pages(self) -> int:
        """Cached pages no live request references (LRU-reclaimable)."""
        return sum(1 for p in self.cached if self.refcount.get(p, 0) == 0)

    def can_alloc(self, n_tokens: int) -> bool:
        return (len(self.free) + self.evictable_pages()
                >= self.pages_needed(n_tokens))

    def _reclaim(self, need: int):
        """Ask the prefix cache (if any) to evict LRU refcount-0 pages."""
        if need > len(self.free) and self.reclaimer is not None:
            self.reclaimer(need - len(self.free))

    def alloc(self, rid: int, n_tokens: int) -> List[int]:
        need = self.pages_needed(n_tokens)
        self._reclaim(need)
        if need > len(self.free):
            raise MemoryError(f"KV pool exhausted ({need} > {len(self.free)})")
        pages = [self.free.pop() for _ in range(need)]
        for p in pages:
            self.refcount[p] = 1
        self.owned.setdefault(rid, []).extend(pages)
        return pages

    def adopt(self, rid: int, pages: Sequence[int]) -> List[int]:
        """Share already-resident pages (a cached prefix) with ``rid``:
        increment each page's refcount and prepend-append them to the
        request's page list.  Must be called before any ``alloc`` for
        ``rid`` so the block table stays position-ordered."""
        pages = list(pages)
        for p in pages:
            if p not in self.refcount:
                raise ValueError(f"page {p} is not live; cannot adopt")
            self.refcount[p] += 1
            self.adopted_refs[p] = self.adopted_refs.get(p, 0) + 1
        self.adopted.setdefault(rid, set()).update(pages)
        self.owned.setdefault(rid, []).extend(pages)
        self._pinned_dirty = True
        return pages

    def extend(self, rid: int, old_tokens: int, new_tokens: int) -> List[int]:
        """Grow a request's allocation (decode appends)."""
        have = self.pages_needed(old_tokens) if old_tokens else 0
        need = self.pages_needed(new_tokens)
        if need <= have:
            return []
        return self.alloc(rid, (need - have) * self.page_size)

    def ensure(self, rid: int, n_tokens: int) -> List[int]:
        """Grow ``rid``'s allocation to cover ``n_tokens`` and return its
        page list.  Chunked prefill allocates pages per chunk as the
        prompt streams in, instead of the whole prompt at admission."""
        self.extend(rid, len(self.owned.get(rid, ())) * self.page_size,
                    n_tokens)
        return self.owned.setdefault(rid, [])

    def free_request(self, rid: int):
        """Drop ``rid``'s references.  Unknown rid (never allocated, or
        already freed) raises — a silent double-free would corrupt the
        refcounts that prefix sharing depends on."""
        if rid not in self.owned:
            raise ValueError(f"free_request({rid}): unknown rid "
                             "(double free?)")
        adopted = self.adopted.pop(rid, ())
        # even an adoption-free release can change pinned state: an
        # allocator freeing a cached page a live adopter still holds
        # turns that page pinned-unaccounted
        self._pinned_dirty = True
        for p in reversed(self.owned.pop(rid)):
            self.refcount[p] -= 1
            if p in adopted:
                self.adopted_refs[p] -= 1
                if self.adopted_refs[p] == 0:
                    del self.adopted_refs[p]
            if self.refcount[p] < 0:
                raise AssertionError(f"page {p}: negative refcount")
            if self.refcount[p] == 0 and p not in self.cached:
                del self.refcount[p]
                self.free.append(p)

    def release_request(self, rid: int) -> bool:
        """Idempotent ``free_request`` for preemption paths (DESIGN.md
        §10): a victim may hold no pages yet (preempted before its first
        prefill chunk) or have been released through the prefix cache
        already.  Returns whether pages were actually dropped.  The
        strict, raising ``free_request`` stays the completion-path API —
        a double free there is still a refcount bug."""
        if rid not in self.owned:
            return False
        self.free_request(rid)
        return True

    # -- prefix-cache pinning -------------------------------------------------
    def mark_cached(self, pages: Sequence[int]):
        """Pin pages: refcount 0 no longer returns them to the free list."""
        for p in pages:
            if p not in self.refcount:
                raise ValueError(f"page {p} is not live; cannot cache")
            self.cached.add(p)
        self._pinned_dirty = True

    def release_cached(self, pages: Sequence[int]) -> int:
        """Unpin pages (prefix-cache eviction); refcount-0 pages return to
        the free list.  Returns how many pages were actually freed."""
        freed = 0
        for p in pages:
            self.cached.discard(p)
            if self.refcount.get(p, 0) == 0:
                self.refcount.pop(p, None)
                self.free.append(p)
                freed += 1
        self._pinned_dirty = True
        return freed

    def pinned_unaccounted_pages(self) -> int:
        """Cache-pinned pages whose only live references are adoptions:
        resident, unreclaimable, yet charged to no KV reservation (the
        adopter's reservation discounts its cached prefix, DESIGN.md
        §10).  The budget check must shrink by these or the token
        accounting could over-commit the physical pool.  A page whose
        original allocator is still live is excluded — that request's
        reservation already covers it.  Memoized: the scan only reruns
        after an adopt/free/pin/unpin mutation, not per admission
        attempt."""
        if self._pinned_dirty:
            self._pinned_memo = sum(
                1 for p in self.cached
                if self.refcount.get(p, 0) > 0
                and self.adopted_refs.get(p, 0) == self.refcount[p])
            self._pinned_dirty = False
        return self._pinned_memo

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self.free)

    def block_table(self, rids: List[int], width: int) -> np.ndarray:
        """Dense (len(rids), width) int32 table, 0-padded (and truncated to
        ``width`` when a request owns more pages than the table is wide)."""
        bt = np.zeros((len(rids), width), np.int32)
        for i, rid in enumerate(rids):
            pages = self.owned.get(rid, [])[:width]
            bt[i, :len(pages)] = pages
        return bt


def make_pools(n_layers: int, n_pages: int, page_size: int, n_kv_heads: int,
               head_dim: int, dtype=torch.float32, quantized: bool = False,
               *, device):
    """Stacked per-layer K/V pools: (L, n_pages, page, Hkv, D), zeroed.

    ``quantized=True`` (DESIGN.md §16) returns int8 payload pools plus
    per-(slot, head) bf16 scale pools (L, n_pages, page, Hkv), the
    ``quantize_kv`` contract.  Zero scales are safe: an unwritten slot
    dequantizes to exact zeros."""
    shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
    if quantized:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
                torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def scatter_prefill(pool, layer_caches, pages: List[int], page_size: int,
                    n_tokens: Optional[int] = None):
    """Scatter contiguous K or V rows (L, S, Hkv, D) into ``pages``,
    zero-filling the rest of the final partial page.  Writes ``pool`` in
    place (the reference returns an updated copy) and returns it.
    ``n_tokens`` caps the copied prefix."""
    S = layer_caches.shape[1]
    if n_tokens is not None:
        S = min(S, n_tokens)
    for pi, pg in enumerate(pages):
        lo = pi * page_size
        if lo >= S:
            break
        hi = min(lo + page_size, S)
        pool[:, pg, :hi - lo] = layer_caches[:, lo:hi]     # in place
        pool[:, pg, hi - lo:] = 0
    return pool


def write_token_to_pool(pool, kv_token, pages: List[int], pos: int,
                        page_size: int):
    """Write one decode token's K or V (L, Hkv, D) at absolute position,
    in place; returns ``pool``."""
    page = pages[pos // page_size]
    slot = pos % page_size
    pool[:, page, slot] = kv_token                          # in place
    return pool
