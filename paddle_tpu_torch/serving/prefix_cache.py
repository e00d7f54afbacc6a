"""Radix prefix cache: shared-prompt KV reuse over the paged pool.

Millions of requests mostly share a handful of system prompts; with the
paged KV layout (kv_cache.py) the shared prefix's pages are already
position-addressed, so reuse is pure host accounting: a radix tree over
token-id sequences, PAGE-granular (one node = one full page = one
`page_size`-token key), maps a prompt's longest cached page-aligned
prefix to a run of pool pages whose KV is already written.

Contract with the engine/scheduler:

  * `lookup(prompt)` walks the trie and — on a hit — takes one pool ref
    per matched page before returning, so the pages cannot be recycled
    between lookup and admission; the caller either installs them in a
    PageTable (the table's `free` drops the refs at retirement) or
    releases them (`pool.free(match.pages)`) if admission fails.
  * `insert(tokens, pages)` publishes fully-written pages after a
    prefill or at retirement; the cache takes its OWN ref per newly
    cached page. Walks dedupe by token content — the first page cached
    for a prefix wins, later identical runs add no refs.
  * shared pages are READ-ONLY to every holder; the one place decode
    must write into a matched page (the full-prompt bootstrap rewrite of
    the last prompt position) is copy-on-write at ADMISSION — the
    scheduler charges one extra page and the engine copies the page
    device-side before the request ever decodes.
  * eviction is LRU over LEAF nodes whose page refcount is exactly 1
    (cache-only): a page any live request still maps stays; `reclaim`
    lets a pool-blocked admission shed cold cached pages so the cache
    can never deadlock the pool. `budget_pages`
    (PADDLE_TPU_PREFIX_CACHE_PAGES) bounds what the cache holds.

Pure host logic, no torch — unit-testable without a model, like the
scheduler.
"""
from __future__ import annotations

import itertools
import threading
import weakref

import numpy as np

from ..observability import registry as _obs
from .kv_cache import PagePool

__all__ = ["PrefixCache", "PrefixMatch"]

# prefix plane (labeled per cache instance = engine id); the ratchet in
# analysis/rules/invariants.py pins these names
_HITS = _obs.counter(
    "paddle_tpu_prefix_lookup_hits_total",
    "admission lookups that matched >=1 cached page", ["cache"])
_MISSES = _obs.counter(
    "paddle_tpu_prefix_lookup_misses_total",
    "admission lookups that matched nothing", ["cache"])
_TOKENS_SAVED = _obs.counter(
    "paddle_tpu_prefix_prefill_tokens_saved_total",
    "prompt tokens whose prefill was skipped via cached pages",
    ["cache"])
_COW = _obs.counter(
    "paddle_tpu_prefix_cow_copies_total",
    "copy-on-write page copies (full-prompt bootstrap admissions)",
    ["cache"])
_EVICTED = _obs.counter(
    "paddle_tpu_prefix_evicted_pages_total",
    "cached pages evicted (LRU budget + reclaim)", ["cache"])
_CACHED = _obs.gauge(
    "paddle_tpu_prefix_cached_pages",
    "pages currently held by the prefix cache (live)", ["cache"])
_SHARED = _obs.gauge(
    "paddle_tpu_prefix_shared_pages",
    "pool pages with more than one holder (live)", ["cache"])

_cache_ids = itertools.count()


def _drop_cache_series(inst: str):
    for m in (_HITS, _MISSES, _TOKENS_SAVED, _COW, _EVICTED, _CACHED,
              _SHARED):
        m.remove_matching(cache=inst)


class PrefixMatch:
    """One lookup hit: `pages` (refs already taken), `tokens` matched
    (= len(pages) * page_size), `full` = the whole prompt was cached."""

    __slots__ = ("pages", "tokens", "full")

    def __init__(self, pages: list[int], tokens: int, full: bool):
        self.pages = pages
        self.tokens = tokens
        self.full = full


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page, parent):
        self.key = key               # tuple of page_size token ids
        self.page = page             # pool page index backing the key
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Page-granular radix trie over token ids -> refcounted page runs."""

    def __init__(self, pool: PagePool, budget_pages: int,
                 inst: str | None = None):
        if budget_pages <= 0:
            raise ValueError("budget_pages must be positive")
        self.pool = pool
        self.page_size = pool.page_size
        self.budget_pages = budget_pages
        self._root = _Node((), -1, None)
        self._lock = threading.Lock()
        self._cached = 0             # nodes (= pages) held
        self._clock = itertools.count(1)   # LRU stamps, no wall time
        self.inst = inst if inst is not None else f"pc{next(_cache_ids)}"
        self._m_hits = _HITS.labels(cache=self.inst)
        self._m_misses = _MISSES.labels(cache=self.inst)
        self._m_saved = _TOKENS_SAVED.labels(cache=self.inst)
        self._m_cow = _COW.labels(cache=self.inst)
        self._m_evicted = _EVICTED.labels(cache=self.inst)
        wr = weakref.ref(self)
        _CACHED.labels(cache=self.inst).set_function(
            lambda: (lambda c: float(c._cached) if c else 0.0)(wr()))
        _SHARED.labels(cache=self.inst).set_function(
            lambda: (lambda c: float(c.pool.shared_pages) if c else 0.0)(
                wr()))
        weakref.finalize(self, _drop_cache_series, self.inst)

    # -- lookup (admission path) ---------------------------------------
    def lookup(self, prompt) -> PrefixMatch | None:
        """Longest cached page-aligned prefix of `prompt`, or None.
        Takes one pool ref per matched page BEFORE returning (under the
        cache lock, so no eviction can recycle them in between); the
        caller owns those refs."""
        toks = np.asarray(prompt).reshape(-1)
        ps = self.page_size
        pages: list[int] = []
        with self._lock:
            node = self._root
            for i in range(int(toks.size) // ps):
                key = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
                child = node.children.get(key)
                if child is None:
                    break
                node = child
                node.last_used = next(self._clock)
                pages.append(node.page)
            if not pages:
                self._m_misses.inc()
                return None
            self.pool.ref(pages)
        self._m_hits.inc()
        self._m_saved.inc(len(pages) * ps)
        return PrefixMatch(list(pages), len(pages) * ps,
                           full=len(pages) * ps == int(toks.size))

    # -- insert (post-prefill / retirement) ----------------------------
    def insert(self, tokens, pages: list[int]) -> int:
        """Publish `pages[i]` as the KV of tokens[i*ps:(i+1)*ps] given
        the preceding pages. Existing nodes win (content-identical by
        construction: the token path determines positions and KV);
        only NEW nodes take a cache ref. Returns pages newly cached."""
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        if len(pages) * ps > toks.size:
            raise ValueError(
                f"{len(pages)} pages need {len(pages) * ps} tokens, "
                f"got {toks.size}")
        added = 0
        with self._lock:
            node = self._root
            for i, page in enumerate(pages):
                key = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
                child = node.children.get(key)
                if child is None:
                    child = _Node(key, page, node)
                    node.children[key] = child
                    self.pool.ref([page])
                    self._cached += 1
                    added += 1
                child.last_used = next(self._clock)
                node = child
            self._evict_locked(self.budget_pages)
        return added

    def note_cow(self):
        self._m_cow.inc()

    # -- eviction ------------------------------------------------------
    def _leaves(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                yield n

    def _evict_locked(self, target: int) -> int:
        """Evict LRU cache-only leaves until at most `target` pages are
        held (a page a live request still refs is never evicted — its
        refcount is > 1). Evicting a leaf can expose its parent as the
        next candidate, so this loops node by node."""
        dropped = 0
        while self._cached > target:
            victim = None
            for n in self._leaves():
                if self.pool.refcount(n.page) != 1:
                    continue
                if victim is None or n.last_used < victim.last_used:
                    victim = n
            if victim is None:
                break                # everything left is in live use
            del victim.parent.children[victim.key]
            self.pool.free([victim.page])
            self._cached -= 1
            dropped += 1
        if dropped:
            self._m_evicted.inc(dropped)
        return dropped

    def reclaim(self, n: int) -> int:
        """Shed up to `n` cold cached pages regardless of budget — the
        scheduler calls this when the pool blocks an admission, so
        cache-held pages can never starve live traffic."""
        with self._lock:
            return self._evict_locked(max(0, self._cached - n))

    # -- defrag --------------------------------------------------------
    def pages(self) -> list[int]:
        with self._lock:
            return [n.page for n in self._walk()]

    def _walk(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def remap(self, mapping: dict[int, int]):
        """Rewrite cached page indices after a defrag (the pool refs
        moved with the pages; only the trie's addresses change)."""
        with self._lock:
            for n in self._walk():
                n.page = mapping.get(n.page, n.page)

    # -- stats ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            cached = self._cached
        return {"cached_pages": cached,
                "budget_pages": self.budget_pages,
                "shared_pages": self.pool.shared_pages,
                "hits": int(self._m_hits.value),
                "misses": int(self._m_misses.value),
                "tokens_saved": int(self._m_saved.value),
                "cow_copies": int(self._m_cow.value),
                "evicted_pages": int(self._m_evicted.value)}
