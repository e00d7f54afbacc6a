"""Paged KV-cache management: fixed-size pages in preallocated pools.

Ragged Paged Attention (PAPERS.md) shape: the KV history of every
in-flight request lives in fixed-size pages of ONE preallocated device
pool per engine (no per-request HBM allocs, no reshape/realloc as
sequences grow), addressed through a per-request page table. This module
is the host-side accountant:

  * `PagePool` — free-list allocator over `num_pages` page slots with
    capacity-based admission control (`can_admit`), occupancy stats, and
    REFCOUNTS: a page handed out once may be shared by several holders
    (page tables of requests with a common prompt prefix, plus the
    prefix cache itself — serving/prefix_cache.py); `free` decrements
    and the page only returns to the free list at zero;
  * `PageTable` — one request's ordered page list + logical length;
  * `defrag` — compacts live pages to the low end of the pool (device
    gather + table rewrite) so a long-running engine can shrink its pool
    or snapshot a dense prefix. Shared pages move once and every holder
    is rewritten through the same mapping.

The device arrays themselves ([L, P, ps, H, d] pools) are built by the
model adapter (serving/model.py); the pool hands out page INDICES only,
so the accountant stays synchronous and lock-cheap while all array work
remains inside the model's step.
"""
from __future__ import annotations

import itertools
import math
import threading
import weakref

from ..observability import registry as _obs

__all__ = ["PagePool", "PageTable", "pages_needed", "defrag_plan"]

# page accounting on the process-wide registry (labeled per pool
# instance); PagePool.stats() keys are unchanged — they now READ these
# (always=True: the legacy counters must keep counting even when the
# telemetry kill switch is on)
_PAGE_ALLOCS = _obs.counter(
    "paddle_tpu_serving_pages_alloc_total",
    "pages handed out by the pool", ["pool"], always=True)
_PAGE_FREES = _obs.counter(
    "paddle_tpu_serving_pages_freed_total",
    "pages returned to the pool", ["pool"], always=True)
_PAGE_ALLOC_FAILURES = _obs.counter(
    "paddle_tpu_serving_page_alloc_failures_total",
    "allocations refused for lack of free pages", ["pool"],
    always=True)

_pool_ids = itertools.count()


def _drop_pool_series(inst: str):
    for m in (_PAGE_ALLOCS, _PAGE_FREES, _PAGE_ALLOC_FAILURES):
        m.remove_matching(pool=inst)


def pages_needed(total_tokens: int, page_size: int) -> int:
    return max(1, math.ceil(total_tokens / page_size))


class PageTable:
    """Ordered page-index list for one request; `pages[i]` backs logical
    positions [i*page_size, (i+1)*page_size)."""

    __slots__ = ("pages", "page_size", "length")

    def __init__(self, page_size: int):
        self.pages: list[int] = []
        self.page_size = page_size
        self.length = 0          # logical tokens written

    def padded(self, max_pages: int, fill: int = 0) -> list[int]:
        """Fixed-width row for the model step (missing entries point at
        page `fill`; they are masked by ctx_len and never read live)."""
        if len(self.pages) > max_pages:
            raise ValueError(
                f"request uses {len(self.pages)} pages > bucket width "
                f"{max_pages}")
        return self.pages + [fill] * (max_pages - len(self.pages))


class PagePool:
    """Free-list page allocator with admission control.

    Thread-safe: the scheduler thread allocates/frees while frontend
    threads ask `can_admit` for backpressure decisions.
    """

    def __init__(self, num_pages: int, page_size: int,
                 inst: str | None = None):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._lock = threading.Lock()
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> low idx
        # refcount per ALLOCATED page (absent = free). alloc() starts a
        # page at 1; ref() adds holders (prefix-cache hits); free()
        # decrements and recycles only at zero — the invariant the
        # shared-prefix machinery rests on.
        self._refs: dict[int, int] = {}
        # stats — registry-backed series labeled per pool instance
        # (`inst` lets an Engine align the pool's label with its own)
        self.inst = inst if inst is not None else f"p{next(_pool_ids)}"
        self._m_allocs = _PAGE_ALLOCS.labels(pool=self.inst)
        self._m_frees = _PAGE_FREES.labels(pool=self.inst)
        self._m_alloc_failures = _PAGE_ALLOC_FAILURES.labels(
            pool=self.inst)
        # a dead pool's series leave the exposition (else a process
        # that churns pools grows its /metrics forever)
        weakref.finalize(self, _drop_pool_series, self.inst)

    # legacy counter attributes (the original stats surface) now read the
    # registry series
    @property
    def alloc_count(self) -> int:
        return int(self._m_allocs.value)

    @property
    def free_count(self) -> int:
        return int(self._m_frees.value)

    @property
    def alloc_failures(self) -> int:
        return int(self._m_alloc_failures.value)

    # -- capacity ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    @property
    def occupancy(self) -> float:
        return self.used_pages / self.num_pages

    def can_admit(self, total_tokens: int) -> bool:
        """Admission control: admit only when the request's WORST-CASE
        page demand (prompt + max new tokens) fits in the free list, so
        an admitted request can never deadlock the pool mid-decode."""
        return pages_needed(total_tokens, self.page_size) <= self.free_pages

    @property
    def shared_pages(self) -> int:
        """Pages currently held by more than one holder."""
        with self._lock:
            return sum(1 for c in self._refs.values() if c > 1)

    def is_shared(self, page: int) -> bool:
        with self._lock:
            return self._refs.get(page, 0) > 1

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    # -- alloc/free ----------------------------------------------------
    def alloc(self, n: int) -> list[int] | None:
        """n pages, or None (and no partial allocation) if unavailable."""
        with self._lock:
            if n > len(self._free):
                self._m_alloc_failures.inc()
                return None
            got = [self._free.pop() for _ in range(n)]
            for p in got:
                self._refs[p] = 1
        self._m_allocs.inc(n)
        return got

    def ref(self, pages) -> None:
        """Add one holder to each (already-allocated) page — the
        prefix-cache hit path: a request admitted onto cached pages
        shares them until its own `free`."""
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"ref of free page {p}")
            for p in pages:
                self._refs[p] += 1

    def alloc_table(self, total_tokens: int) -> PageTable | None:
        pages = self.alloc(pages_needed(total_tokens, self.page_size))
        if pages is None:
            return None
        t = PageTable(self.page_size)
        t.pages = pages
        return t

    def free(self, table_or_pages) -> None:
        """Drop one holder per page; pages whose refcount reaches zero
        return to the free list (freed-page metric counts only those)."""
        pages = table_or_pages.pages if isinstance(table_or_pages, PageTable) \
            else list(table_or_pages)
        with self._lock:
            for p in pages:
                if not 0 <= p < self.num_pages:
                    raise ValueError(f"page {p} outside pool")
                if p not in self._refs:
                    raise ValueError(f"double free of page {p}")
            recycled = []
            for p in pages:
                c = self._refs[p] - 1
                if c:
                    self._refs[p] = c
                else:
                    del self._refs[p]
                    recycled.append(p)
            self._free.extend(sorted(recycled, reverse=True))
        self._m_frees.inc(len(recycled))
        if isinstance(table_or_pages, PageTable):
            table_or_pages.pages = []

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            shared = sum(1 for c in self._refs.values() if c > 1)
        return {"num_pages": self.num_pages, "page_size": self.page_size,
                "free_pages": free,
                "used_pages": self.num_pages - free,
                "occupancy": round(1 - free / self.num_pages, 4),
                "shared_pages": shared,
                "alloc_count": self.alloc_count,
                "free_count": self.free_count,
                "alloc_failures": self.alloc_failures}


def defrag_plan(pool: PagePool, tables: list[PageTable],
                extra_pages=()) -> dict[int, int]:
    """Mapping old_page -> new_page that compacts all live pages into the
    lowest indices (stable: table order, then page order, first holder
    wins for a shared page). The caller applies it to the device pools
    (serving/model.py `apply_defrag`) and this function rewrites tables,
    refcounts, and the free list. `extra_pages` names live pages held
    outside any table (the prefix cache's runs) — the caller must remap
    its own holders with the returned mapping.

    Safe only while the engine step is quiesced (the scheduler calls it
    between steps)."""
    order: list[int] = []
    seen: set[int] = set()
    for p in itertools.chain((p for t in tables for p in t.pages),
                             extra_pages):
        if p not in seen:
            seen.add(p)
            order.append(p)
    mapping = {old: new for new, old in enumerate(order)}
    for t in tables:
        t.pages = [mapping[p] for p in t.pages]
    with pool._lock:
        if seen != set(pool._refs):
            missing = sorted(set(pool._refs) - seen)
            raise ValueError(
                f"defrag plan covers {len(seen)} pages but the pool has "
                f"{len(pool._refs)} allocated (unaccounted: "
                f"{missing[:8]}) — pass every holder's pages")
        pool._refs = {mapping[p]: c for p, c in pool._refs.items()}
        pool._free = list(range(pool.num_pages - 1, len(order) - 1, -1))
    return mapping
