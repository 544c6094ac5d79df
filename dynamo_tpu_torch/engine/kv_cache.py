"""Host-side page allocator (copy of the allocation and prefix-reuse core of
``dynamo_tpu.engine.kv_cache.PageAllocator``).

The device side is two tensors per model, k/v pages
[layers, kv_heads, num_pages, page_size, head_dim], owned by the runner.
The host side hands out page ids. The engine registers each complete
block's page under its chained block hash (``llm/tokens.py``): at placement
for the prompt's blocks, and as generated tokens complete blocks. Pages of
finished sequences stay registered and are reused on prefix hits
(``acquire_cached``) until evicted, or until the admin clear
(``clear_inactive``, the ``clear_kv_blocks`` request) drops them. Every
registration, and every registration dropped (eviction, a replaced hash,
``unregister``, ``clear_inactive``), is buffered as a stored or removed
block hash for the KV router's index, at the reference's points;
``drain_events`` hands them to the engine's publisher. ``stats`` gives the
reference's occupancy and lifecycle counters. ``evict_hook`` hands every
evicted block (allocation pressure or the KVBM watermark sweep,
``demote_lru``) to the engine, which extracts it into the host tier
(``engine/kv_host_cache.py``, policy in ``engine/kvbm.py``).

Lifecycle invariant (as in the reference): a page is either FREE
(unregistered, refcount 0), ACTIVE (refcount > 0 — held by one or more
live sequences; may also be registered for sharing), or INACTIVE
(registered, refcount 0 — reusable on a prefix hit, evictable LRU). Only
INACTIVE pages may be evicted: evicting a page a live sequence still
writes to would silently corrupt its KV.
"""

from __future__ import annotations

from collections import OrderedDict


class PageAllocator:
    # Page 0 is RESERVED as the scratch page: inactive decode slots have
    # all-zero page tables, so their dummy K/V scatters land there instead of
    # clobbering live data. Never allocated.
    SCRATCH_PAGE = 0

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages - 1  # page 0 reserved
        self.page_size = page_size
        self.free: list[int] = list(range(num_pages - 1, 0, -1))
        # All registered blocks: block_hash -> page id.
        self.cached: dict[int, int] = {}
        self.cached_by_page: dict[int, int] = {}
        # INACTIVE subset (registered AND refcount 0) in LRU order — the
        # only pages eviction may take.
        self.inactive: OrderedDict[int, int] = OrderedDict()
        # Active references: page id -> refcount.
        self.refs: dict[int, int] = {}
        # Router event buffers.
        self.stored_events: list[int] = []
        self.removed_events: list[int] = []
        # Telemetry (plain ints on the engine thread's hot path).
        self.reuse_hit_blocks = 0      # cached pages pinned on prefix hits
        self.reuse_lookup_blocks = 0   # blocks probed by acquire_cached
        self.evicted_blocks = 0        # LRU evictions under allocation
        self.demoted_blocks = 0        # proactive watermark demotions (KVBM)
        self.cleared_blocks = 0        # pages reclaimed by clear_inactive
        self.clear_inactive_calls = 0
        # Offload hook (G2 tiering): called as hook(block_hash, page) when
        # an inactive registered page is evicted, BEFORE the page can be
        # handed out; the engine schedules a device->host extract so the
        # block survives in the host tier.
        self.evict_hook = None

    # -- queries --------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free) + len(self.inactive)

    @property
    def num_active(self) -> int:
        return len(self.refs)

    def lookup(self, block_hashes: list[int]) -> list[int]:
        """Page ids for the longest cached prefix of ``block_hashes``."""
        pages = []
        for h in block_hashes:
            page = self.cached.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    # -- allocation -----------------------------------------------------------
    def allocate(self, count: int) -> list[int] | None:
        """Allocate ``count`` fresh pages (evicting LRU *inactive* cached
        pages as needed — never a page a live sequence holds). None if
        impossible."""
        if self.num_free < count:
            return None
        out = []
        for _ in range(count):
            if self.free:
                page = self.free.pop()
            else:
                # Evict least-recently-used inactive page.
                h, page = self.inactive.popitem(last=False)
                del self.cached[h]
                del self.cached_by_page[page]
                self.removed_events.append(h)
                self.evicted_blocks += 1
                if self.evict_hook is not None:
                    self.evict_hook(h, page)
            assert page not in self.refs, \
                f"allocator invariant violated: page {page} already active"
            self.refs[page] = 1
            out.append(page)
        return out

    def acquire_cached(self, block_hashes: list[int]) -> list[int]:
        """Pin the cached prefix pages for reuse; returns their page ids."""
        pages = []
        self.reuse_lookup_blocks += len(block_hashes)
        for h in block_hashes:
            page = self.cached.get(h)
            if page is None:
                break
            self.reuse_hit_blocks += 1
            # Inactive -> active (stays registered so other sequences can
            # share — refcount tracks active users).
            self.inactive.pop(h, None)
            self.refs[page] = self.refs.get(page, 0) + 1
            pages.append(page)
        return pages

    def register(self, page: int, block_hash: int) -> None:
        """A page now holds a COMPLETE block: make it reusable by hash."""
        existing = self.cached_by_page.get(page)
        if existing == block_hash:
            return
        if existing is not None:
            # The page's content no longer matches its old hash: drop the
            # stale registration entirely.
            del self.cached_by_page[page]
            self.cached.pop(existing, None)
            self.inactive.pop(existing, None)
            self.removed_events.append(existing)
        if block_hash in self.cached:
            # Another page already holds this block; keep the older one. A
            # page whose old registration we just dropped must not leak out
            # of every pool: unreferenced -> back to free.
            if existing is not None and page not in self.refs:
                self.free.append(page)
            return
        self.cached[block_hash] = page
        self.cached_by_page[page] = block_hash
        if page not in self.refs:
            self.inactive[block_hash] = page
        self.stored_events.append(block_hash)

    def unregister(self, pages: list[int]) -> None:
        """Drop these pages' prefix-cache registrations (used when a request
        fails and its KV contents must not be reused)."""
        for page in pages:
            h = self.cached_by_page.pop(page, None)
            if h is not None:
                self.cached.pop(h, None)
                self.inactive.pop(h, None)
                self.removed_events.append(h)
                if page not in self.refs:
                    self.free.append(page)

    def release(self, pages: list[int]) -> None:
        """Drop one active reference; unreferenced unregistered pages return
        to the free list, registered ones become inactive (reusable LRU,
        most-recently-released last)."""
        for page in pages:
            ref = self.refs.get(page)
            if ref is None:
                continue
            if ref > 1:
                self.refs[page] = ref - 1
                continue
            del self.refs[page]
            h = self.cached_by_page.get(page)
            if h is None:
                self.free.append(page)
            else:
                self.inactive[h] = page

    def demote_lru(self, count: int,
                   skip: frozenset | set = frozenset()) -> list[int]:
        """Proactively demote up to ``count`` LRU *inactive* blocks out of
        the pool (the KVBM watermark sweep, ``engine/kvbm.py``): the pages
        return to the free list and the evict hook offloads their contents
        to the host tier, as allocation-pressure eviction does, but before
        an allocation burst has to pay for it. Hashes in ``skip`` (the
        KVBM pin set) and ACTIVE pages are never taken. Returns the
        demoted block hashes."""
        out: list[int] = []
        for h in list(self.inactive):
            if len(out) >= count:
                break
            if h in skip:
                continue
            page = self.inactive.pop(h)
            del self.cached[h]
            del self.cached_by_page[page]
            self.removed_events.append(h)
            self.demoted_blocks += 1
            if self.evict_hook is not None:
                self.evict_hook(h, page)
            self.free.append(page)
            out.append(h)
        return out

    def clear_inactive(self) -> int:
        """Drop every INACTIVE prefix-cache registration (pages held by
        live sequences are untouched): the reference's clear_kv_blocks
        admin operation. Returns the number of pages freed."""
        n = 0
        for h, page in list(self.inactive.items()):
            del self.inactive[h]
            self.cached.pop(h, None)
            self.cached_by_page.pop(page, None)
            self.removed_events.append(h)
            self.free.append(page)
            n += 1
        self.clear_inactive_calls += 1
        self.cleared_blocks += n
        return n

    def stats(self) -> dict:
        """Occupancy and lifecycle counters (the reference's keys)."""
        return {
            "pages_total": self.num_pages,
            "pages_free": len(self.free),
            "pages_active": len(self.refs),
            "pages_inactive": len(self.inactive),
            "cached_blocks": len(self.cached),
            "occupancy": (len(self.refs) / self.num_pages
                          if self.num_pages else 0.0),
            "reuse_hit_blocks": self.reuse_hit_blocks,
            "reuse_lookup_blocks": self.reuse_lookup_blocks,
            "evicted_blocks": self.evicted_blocks,
            "demoted_blocks": self.demoted_blocks,
            "cleared_blocks": self.cleared_blocks,
            "clear_inactive_calls": self.clear_inactive_calls,
        }

    def drain_events(self) -> tuple[list[int], list[int]]:
        """The (stored, removed) block hashes buffered since the last
        drain."""
        stored, self.stored_events = self.stored_events, []
        removed, self.removed_events = self.removed_events, []
        return stored, removed
