"""Paged KV-cache bookkeeping: page allocator, refcounts, prefix index
(ref: mxnet_tpu/serve/paging.py).

The decode tier's paged arena (``DecodeServer(page_tokens=...)``) keeps
its cache buffers as ``(num_pages + 1, page_tokens, ...)`` pools and
maps each slot's logical ``[0, pages_per_slot * page_tokens)`` token
range onto physical pages through a per-slot page table.  Everything in
this module is HOST-side bookkeeping — pure python over small ints,
mutated only between token boundaries by the decode loop thread — so
the device-side steps stay fixed-shape: the page table rides into the
step as a ``(max_slots, pages_per_slot)`` int32 input, and gather/scatter
against it happens inside the one captured step.

Three pieces:

:class:`PageAllocator`
    Free-list + refcount ledger over ``num_pages`` physical pages.
    Index ``num_pages`` (``.trash``) is a reserved sink page appended
    to every pool: unmapped page-table entries point at it, so masked
    scatters of inactive/unallocated rows land somewhere harmless
    instead of needing data-dependent shapes.  ``check()`` asserts the
    no-leak invariant (every page is exactly one of free / refcounted
    live) — the fragmentation test's anchor.

:class:`PrefixIndex`
    Prompt-prefix dedup at page granularity.  Admission hashes each
    page-sized chunk of the prompt CHAINED (the key digests the whole
    prefix through that chunk, not the chunk alone, so equal chunks at
    different positions or after different histories never collide);
    a hit maps the new slot's page-table entry onto the existing page
    with a refcount bump, a miss allocates and registers.  Entries are
    dropped the moment their page's refcount hits zero (eviction only
    at refcount zero): sharing happens among overlapping-lifetime
    requests, and a freed page can never be resurrected stale.

:func:`chunk_keys` / :func:`pages_spanned`
    The hashing and sizing helpers the server's admission path uses.

Copy-on-write is decided here only in the sense that the allocator
exposes refcounts; the actual page copy is folded into the decode step
(see ``serve/decode.py``): when the decode loop finds the
write-frontier page shared (``ref > 1``) it allocates a private page,
redirects the slot's page-table entry, and passes the (src, dst) pair
into the step, which copies the page on-device before the gather — no
extra dispatch, no host round-trip.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..base import MXNetError

__all__ = ["PageAllocator", "PrefixIndex", "chunk_keys", "pages_spanned"]


def pages_spanned(tokens, page_tokens):
    """Pages covering ``tokens`` positions (ceil division)."""
    return -(-int(tokens) // int(page_tokens))


def chunk_keys(prompt, length, page_tokens):
    """Chained page-granularity prefix keys for one prompt.

    Returns one key per prompt page, in page order: full pages get a
    ``("F", i, digest-of-prompt[: (i+1)*T])`` key; a trailing partial
    page gets a ``("P", i, length, digest-of-prompt[:length])`` key.
    The digest always covers the WHOLE prefix through the chunk, so a
    hit guarantees every earlier page matched too, and the full/partial
    kind plus real length in the key keep a partial tail from ever
    colliding with a full page of a longer prompt.
    """
    t = int(page_tokens)
    n = int(length)
    p = np.ascontiguousarray(np.asarray(prompt)[:n], dtype=np.int32)
    keys = []
    h = hashlib.sha1()
    full = n // t
    for i in range(full):
        h.update(p[i * t:(i + 1) * t].tobytes())
        keys.append(("F", i, h.hexdigest()))
    rem = n - full * t
    if rem:
        h.update(p[full * t:n].tobytes())
        keys.append(("P", full, n, h.hexdigest()))
    return keys


class PageAllocator:
    """Free-list + refcount ledger for the paged arena's physical pages.

    Pages are plain ints in ``[0, num_pages)``; ``trash`` (==
    ``num_pages``) is the reserved sink page that exists in the device
    pools but is never allocated — page-table entries that map nothing
    point at it.  All methods are called from the decode loop thread
    only (admission and token boundaries are already serialized), so
    there is no internal lock.
    """

    def __init__(self, num_pages, page_tokens):
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        if self.num_pages < 1 or self.page_tokens < 1:
            raise MXNetError(
                f"PageAllocator needs num_pages >= 1 and page_tokens "
                f">= 1, got {num_pages} x {page_tokens}")
        self.trash = self.num_pages
        # LIFO free list, low indices first out — steady churn reuses
        # a warm working set of pages instead of striding the pool
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._ref = [0] * self.num_pages
        self.allocs = 0
        self.frees = 0

    def alloc(self):
        """Take one free page at refcount 1.  Exhaustion here is a
        bookkeeping BUG (admission commits worst-case pages up front),
        so it raises instead of returning a sentinel."""
        if not self._free:
            raise MXNetError(
                f"page pool exhausted ({self.num_pages} pages of "
                f"{self.page_tokens} tokens) — admission token-budget "
                f"accounting let an uncovered allocation through")
        page = self._free.pop()
        self._ref[page] = 1
        self.allocs += 1
        return page

    def retain(self, page):
        """Add one reference to a live page (a prefix-sharing hit)."""
        if not 0 <= page < self.num_pages or self._ref[page] < 1:
            raise MXNetError(f"retain() of non-live page {page}")
        self._ref[page] += 1
        return page

    def release(self, page):
        """Drop one reference; frees the page (returns True) when the
        count hits zero — eviction happens at refcount zero, never
        earlier."""
        if not 0 <= page < self.num_pages or self._ref[page] < 1:
            raise MXNetError(f"release() of non-live page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            self.frees += 1
            return True
        return False

    def ref(self, page):
        """Current refcount (0 = free)."""
        return self._ref[page]

    def free_count(self):
        return len(self._free)

    def live_count(self):
        return self.num_pages - len(self._free)

    def check(self):
        """Assert the no-leak invariant: every page is exactly one of
        free (ref 0) or live (ref >= 1), with no duplicates in the free
        list.  Returns self so tests can chain."""
        if len(set(self._free)) != len(self._free):
            raise MXNetError("page free list holds duplicates")
        for page in self._free:
            if self._ref[page] != 0:
                raise MXNetError(
                    f"page {page} is free but has refcount "
                    f"{self._ref[page]}")
        live = sum(1 for r in self._ref if r > 0)
        if live + len(self._free) != self.num_pages:
            raise MXNetError(
                f"page ledger leak: {live} live + {len(self._free)} "
                f"free != {self.num_pages} pages")
        return self


class PrefixIndex:
    """Chained prefix-hash -> live page map (storage dedup).

    One entry per registered chunk key; the reverse map lets the
    allocator's free path invalidate every key pointing at a page the
    moment it is evicted, so a lookup can never hand out a freed (or
    recycled) page.
    """

    def __init__(self):
        self._by_key = {}
        self._by_page = {}

    def lookup(self, key):
        """Live page for this chunk key, or None (pure; no refcount
        side effects — the caller retains on use)."""
        return self._by_key.get(key)

    def register(self, key, page):
        """Publish a freshly written page under its chunk key.  First
        writer wins: re-registering a key is a no-op (two identical
        prompts admitted in one group race to the same key; the second
        should have hit instead, but dropping the duplicate keeps the
        index consistent either way)."""
        if key not in self._by_key:
            self._by_key[key] = page
            self._by_page.setdefault(page, set()).add(key)
        return self._by_key[key]

    def drop_page(self, page):
        """Invalidate every key for an evicted page."""
        for key in self._by_page.pop(page, ()):
            self._by_key.pop(key, None)

    def __len__(self):
        return len(self._by_key)
