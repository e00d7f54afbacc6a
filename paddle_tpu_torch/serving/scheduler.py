"""Continuous batcher: request lifecycle + slot scheduling policy.

The serving engine decodes a FIXED-SHAPE slot batch every step (so there
is exactly one decode shape per (slots, pages) bucket); this
module is the policy layer that decides, between steps, which requests
occupy those slots:

  * admission — priority-ordered from the queue into free slots, gated
    by the page pool: a request is admitted only when its WORST-CASE
    page demand (prompt + max_new_tokens) is allocatable, so an admitted
    request can never run out of pages mid-decode (no mid-flight OOM,
    no deadlock). Requests carry a priority TIER (0 = highest); within
    a tier, order is FIFO with head-of-line blocking, and a waiting
    request's effective tier rises one step per `aging_s` seconds so a
    sustained high-tier flood can never starve the low tiers;
  * quotas — per-tenant token buckets charge each ENQUEUED submit its
    worst-case token demand (a submit that bounces off a full queue is
    not charged); an over-quota tenant is rejected at submit
    (`QuotaExceeded`, a `QueueFull` subclass so frontends reply
    "rejected", not a transport error);
  * shedding — when the queue is at capacity, a submit sheds the
    lowest-effective-priority queued request instead of rejecting a
    HIGHER-priority newcomer (status "shed"); equal-or-lower newcomers
    are rejected as before (backpressure semantics unchanged);
  * prefill-then-decode — a newly admitted request is prefilled once
    (its prompt KV written to its pages, first token sampled), then
    joins the in-flight decode batch;
  * eviction — EOS or max_new_tokens completes a request; a missed
    deadline preempts it (partial output returned, ALL its pages freed
    back to the pool that step). A deadline that lapses while the
    request is still QUEUED counts separately (`expired_in_queue`):
    admission-control tuning must distinguish "never ran" from
    "ran out of time mid-decode".

Pure host logic over kv_cache.PagePool — no torch imports — so the policy
is unit-testable without a model (tests/test_torch_serving.py).
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque

import numpy as np

from ..observability import (flight as _flight, meter as _meter,
                             registry as _obs)
from .kv_cache import PagePool, PageTable, pages_needed

__all__ = ["Request", "Scheduler", "QueueFull", "QuotaExceeded",
           "TokenBucket"]

# lifecycle counters on the process-wide registry, labeled per scheduler
# instance; Scheduler.stats() keys are unchanged — they now READ these
# (always=True: legacy surface must keep counting under the telemetry
# kill switch)
_ADMITTED = _obs.counter(
    "paddle_tpu_serving_admitted_total",
    "requests admitted into a slot", ["inst"], always=True)
_COMPLETED = _obs.counter(
    "paddle_tpu_serving_completed_total",
    "requests finished with status done", ["inst"], always=True)
_PREEMPTED = _obs.counter(
    "paddle_tpu_serving_preempted_total",
    "running requests preempted by a deadline", ["inst"], always=True)
_REJECTED = _obs.counter(
    "paddle_tpu_serving_rejected_total",
    "submits rejected by queue backpressure", ["inst"], always=True)
_EVICTIONS = _obs.counter(
    "paddle_tpu_serving_evictions_total",
    "requests leaving the slot table / queue, by reason",
    ["inst", "reason"])
_EXPIRED_QUEUE = _obs.counter(
    "paddle_tpu_serving_expired_in_queue_total",
    "queued requests whose deadline lapsed before they ever ran "
    "(distinct from running-request preemptions)", ["inst"],
    always=True)
_SHED = _obs.counter(
    "paddle_tpu_serving_shed_total",
    "queued requests shed to make room for a higher-priority submit",
    ["inst"], always=True)
_QUOTA_REJECTED = _obs.counter(
    "paddle_tpu_serving_quota_rejected_total",
    "submits rejected by a tenant token-bucket quota", ["inst"],
    always=True)

_sched_ids = itertools.count()


def _drop_sched_series(inst: str):
    for m in (_ADMITTED, _COMPLETED, _PREEMPTED, _REJECTED, _EVICTIONS,
              _EXPIRED_QUEUE, _SHED, _QUOTA_REJECTED):
        m.remove_matching(inst=inst)


class QueueFull(RuntimeError):
    """Backpressure: the engine's admission queue is at capacity."""


class QuotaExceeded(QueueFull):
    """The tenant's token bucket cannot cover this request right now.
    Subclasses QueueFull so every existing backpressure handler (the
    frontend's "rejected" reply, client retry policies) treats it as
    load shedding, never a transport error."""


class TokenBucket:
    """Per-tenant admission quota: `rate` tokens/sec refill up to
    `burst`. Charged the request's WORST-CASE token demand at submit
    (prompt + max_new_tokens) — the same worst-case currency the page
    pool admits on. Clock injectable for deterministic tests."""

    __slots__ = ("rate", "burst", "_tokens", "_t", "_now")

    def __init__(self, rate: float, burst: float | None = None,
                 now=time.monotonic):
        if rate <= 0:
            raise ValueError("rate must be positive")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._tokens = self.burst
        self._now = now
        self._t = now()

    def available(self) -> float:
        t = self._now()
        self._tokens = min(self.burst,
                           self._tokens + (t - self._t) * self.rate)
        self._t = t
        return self._tokens

    def take(self, n: float) -> bool:
        if self.available() < n:
            return False
        self._tokens -= n
        return True


_req_ids = itertools.count(1)


class Request:
    """One generation request, queued -> running -> finished.

    status: queued | running | done | deadline | error | cancelled |
    shed. `deadline` is an absolute time.monotonic() stamp (None = no
    bound). `priority` is a tier (0 = highest; default 1); `tenant`
    names the quota bucket the request is charged against.
    """

    def __init__(self, prompt, max_new_tokens: int, deadline: float | None
                 = None, eos_id: int | None = None, priority: int = 1,
                 tenant: str = "default", temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: int | None = None):
        self.id = next(_req_ids)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.deadline = deadline
        self.eos_id = eos_id
        self.priority = max(0, int(priority))
        self.tenant = str(tenant)
        # stochastic decode (serving/sampling.py): temperature 0 =
        # greedy; seed None = keyed by the request identity (engine)
        self.temperature = float(temperature)
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        self.top_k = max(0, int(top_k))
        self.top_p = float(top_p)
        if not 0 < self.top_p <= 1:
            raise ValueError("top_p must be in (0, 1]")
        self.seed = None if seed is None else int(seed)
        # shared-prefix admission (serving/prefix_cache.py): the match
        # this request was admitted onto, and — for a full-prompt
        # bootstrap — the pending (src, dst) copy-on-write pair whose
        # src ref is pinned until the engine's device copy
        self.prefix_match = None
        self.prefix_cow: tuple[int, int] | None = None
        self.trace_id: str | None = None  # set by Engine.submit
        self.generated: list[int] = []
        self.status = "queued"
        self.error: str | None = None
        self.table = None            # PageTable while admitted
        self.slot: int | None = None
        self.submitted_at = time.monotonic()
        self.started_at: float | None = None
        self.finished_at: float | None = None
        # stamped on the SCHEDULER's clock (injectable in tests):
        # _queued_at anchors priority aging; first/last_token_at are the
        # SLO surface (TTFT, inter-token latency) the load generator
        # reads (serving/loadgen.py)
        self._queued_at: float | None = None
        self.first_token_at: float | None = None
        self.last_token_at: float | None = None
        self._finished = False       # set once, under the scheduler lock
        self._done = threading.Event()
        # token-progress condition for streaming consumers: notified on
        # every recorded token and on finish. A leaf lock — holders
        # never take the scheduler or engine step lock under it.
        self._progress = threading.Condition()

    # -- results -------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Generated tokens (possibly partial on deadline preemption).
        Raises on error status; TimeoutError if not finished in time."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished")
        if self.status == "error":
            raise RuntimeError(self.error or "request failed")
        return np.asarray(self.generated, np.int32)

    def _notify_progress(self):
        with self._progress:
            self._progress.notify_all()

    def next_tokens(self, start: int, timeout: float | None = None) \
            -> tuple[list[int], bool]:
        """Block until tokens beyond index `start` exist or the request
        finished; returns (new_tokens, done). The streaming frontends
        poll this from their handler threads — `generated` is only ever
        appended, so the slice is safe to read concurrently (a token
        appended between wakeup and slice just arrives early)."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._progress:
            while len(self.generated) <= start \
                    and not self._done.is_set():
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._progress.wait(remaining)
        return list(self.generated[start:]), self._done.is_set()

    @property
    def total_tokens(self) -> int:
        return int(self.prompt.size) + self.max_new_tokens

    @property
    def position(self) -> int:
        """Position of the LAST generated token (its KV is written by the
        next decode step)."""
        return int(self.prompt.size) + len(self.generated) - 1

    def latency(self) -> float | None:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def ttft(self) -> float | None:
        """Time to first token (submit -> first sampled token)."""
        if self.first_token_at is None or self._queued_at is None:
            return None
        return self.first_token_at - self._queued_at

    def inter_token(self) -> float | None:
        """Mean inter-token latency over this request's decode."""
        if (self.first_token_at is None or self.last_token_at is None
                or len(self.generated) < 2):
            return None
        return (self.last_token_at - self.first_token_at) \
            / (len(self.generated) - 1)


class Scheduler:
    """Slot table + queue; the engine calls the methods between steps."""

    def __init__(self, pool: PagePool, num_slots: int,
                 max_seq_len: int, max_queue: int = 256,
                 now=time.monotonic, inst: str | None = None,
                 aging_s: float = 30.0):
        self.pool = pool
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.max_queue = max_queue
        self.now = now
        # a queued request's effective tier rises one step per aging_s
        # seconds waited, so a sustained high-tier flood can never
        # starve the low tiers (<=0 disables aging)
        self.aging_s = aging_s
        self.slots: list[Request | None] = [None] * num_slots
        self.queue: deque[Request] = deque()
        self.quotas: dict[str, TokenBucket] = {}
        # shared-prefix admission: installed by the Engine when
        # PADDLE_TPU_PREFIX_CACHE_PAGES > 0 (serving/prefix_cache.py)
        self.prefix_cache = None
        # graceful drain: True = admit nothing new, finish what's here
        # (the router stops routing to a draining replica; docs/SERVING.md)
        self.draining = False
        self._lock = threading.Lock()
        # counters (engine /stats) — registry-backed, labeled per
        # instance (`inst` lets the Engine align the label with its own)
        self.inst = inst if inst is not None else f"s{next(_sched_ids)}"
        self._m_admitted = _ADMITTED.labels(inst=self.inst)
        self._m_completed = _COMPLETED.labels(inst=self.inst)
        self._m_preempted = _PREEMPTED.labels(inst=self.inst)
        self._m_rejected = _REJECTED.labels(inst=self.inst)
        self._m_expired_queue = _EXPIRED_QUEUE.labels(inst=self.inst)
        self._m_shed = _SHED.labels(inst=self.inst)
        self._m_quota_rejected = _QUOTA_REJECTED.labels(inst=self.inst)
        # a dead scheduler's series leave the exposition
        weakref.finalize(self, _drop_sched_series, self.inst)

    # legacy counter attributes (the original stats surface) now read the
    # registry series
    @property
    def admitted(self) -> int:
        return int(self._m_admitted.value)

    @property
    def completed(self) -> int:
        return int(self._m_completed.value)

    @property
    def preemptions(self) -> int:
        return int(self._m_preempted.value)

    @property
    def rejected(self) -> int:
        return int(self._m_rejected.value)

    @property
    def expired_in_queue(self) -> int:
        return int(self._m_expired_queue.value)

    @property
    def shed(self) -> int:
        return int(self._m_shed.value)

    @property
    def quota_rejected(self) -> int:
        return int(self._m_quota_rejected.value)

    # -- admission policy ----------------------------------------------
    def set_tenant_quota(self, tenant: str, tokens_per_sec: float,
                         burst: float | None = None):
        """Install (or replace) a token-bucket quota for `tenant`; each
        submit is charged its worst-case token demand. Tenants without
        a bucket are unthrottled."""
        self.quotas[str(tenant)] = TokenBucket(
            tokens_per_sec, burst, now=self.now)

    def effective_priority(self, req: Request, t: float | None = None) \
            -> int:
        """The request's tier after aging: one step toward 0 per
        `aging_s` seconds waited in the queue."""
        if self.aging_s <= 0 or req._queued_at is None:
            return req.priority
        t = self.now() if t is None else t
        return max(0, req.priority
                   - int((t - req._queued_at) // self.aging_s))

    # -- queue side (frontend threads) ---------------------------------
    def submit(self, req: Request) -> Request:
        if req.total_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt+max_new_tokens = {req.total_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}")
        victim: Request | None = None
        with self._lock:
            if self.draining:
                # drain semantics: every in-flight/queued request
                # finishes, nothing new is admitted — the standard
                # backpressure reply ("rejected") tells well-behaved
                # clients and the router to go elsewhere
                self._m_rejected.inc()
                _meter.METER.note_outcome(req.tenant, req.priority,
                                          "rejected")
                _flight.record("serving", "reject",
                               trace_id=req.trace_id, inst=self.inst,
                               request=req.id, reason="draining")
                raise QueueFull("draining: not admitting new requests")
            t = self.now()
            req._queued_at = t
            bucket = self.quotas.get(req.tenant)
            # quota is CHECKED here but only CHARGED once the request
            # is actually enqueued (below): a submit that bounces off a
            # full queue must not drain the tenant's bucket, or retries
            # against backpressure turn into phantom quota rejections
            if bucket is not None \
                    and bucket.available() < req.total_tokens:
                self._m_quota_rejected.inc()
                _meter.METER.note_outcome(req.tenant, req.priority,
                                          "quota")
                _flight.record("serving", "reject",
                               trace_id=req.trace_id, inst=self.inst,
                               request=req.id, reason="quota",
                               tenant=req.tenant,
                               need_tokens=req.total_tokens)
                raise QuotaExceeded(
                    f"tenant {req.tenant!r} over quota "
                    f"({req.total_tokens} tokens); retry later")
            if len(self.queue) >= self.max_queue:
                # load-shed by priority: a saturated queue drops its
                # lowest-effective-priority entry for a strictly
                # higher-priority newcomer; otherwise the newcomer is
                # rejected (plain backpressure, unchanged semantics)
                worst = max(self.queue,
                            key=lambda r: (self.effective_priority(r, t),
                                           r.id), default=None)
                if worst is not None \
                        and self.effective_priority(worst, t) \
                        > self.effective_priority(req, t):
                    self.queue.remove(worst)
                    victim = worst
                else:
                    self._m_rejected.inc()
                    _meter.METER.note_outcome(req.tenant, req.priority,
                                              "rejected")
                    _flight.record("serving", "reject",
                                   trace_id=req.trace_id, inst=self.inst,
                                   request=req.id, reason="queue_full",
                                   queue_depth=len(self.queue))
                    raise QueueFull(
                        f"queue at capacity ({self.max_queue}); "
                        f"retry later")
            if bucket is not None:
                # cannot fail: available() was checked under this same
                # lock and no other submit ran since
                bucket.take(req.total_tokens)
            self.queue.append(req)
        if victim is not None:
            self._m_shed.inc()
            _flight.record("serving", "shed", trace_id=victim.trace_id,
                           inst=self.inst, request=victim.id,
                           tier=victim.priority, tenant=victim.tenant,
                           for_request=req.id, for_tier=req.priority)
            self._finish(victim, "shed")
        return req

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self.queue)

    def active_requests(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def idle(self) -> bool:
        return self.queue_depth == 0 and not self.active_requests()

    # -- step side (scheduler thread) ----------------------------------
    def expire_deadlines(self) -> list[Request]:
        """Finish every queued or running request whose deadline passed;
        running ones are PREEMPTED: their pages all go back to the pool
        now, their partial output stands. Queued ones count under the
        distinct `expired_in_queue` key — they never held a slot, and
        admission-control tuning must tell the two apart."""
        t = self.now()
        expired_queued: list[Request] = []
        hit: list[Request] = []
        with self._lock:
            kept = deque()
            for r in self.queue:
                if r.deadline is not None and t > r.deadline:
                    expired_queued.append(r)
                else:
                    kept.append(r)
            self.queue = kept
        for r in expired_queued:
            self._m_expired_queue.inc()
            self._finish(r, "deadline", reason="expired_in_queue")
            hit.append(r)
        for i, r in enumerate(self.slots):
            if r is not None and r.deadline is not None and t > r.deadline:
                self.slots[i] = None
                self._m_preempted.inc()
                self._finish(r, "deadline")
                hit.append(r)
        return hit

    def _pick_head(self, t: float) -> Request | None:
        """The queue's admission head: best (aged) tier, then FIFO.
        Head-of-line blocking applies to THIS request — a pool-blocked
        head is never bypassed by a smaller lower-priority request
        (fairness over utilization, as in the original FIFO)."""
        return min(self.queue,
                   key=lambda r: (self.effective_priority(r, t), r.id),
                   default=None)

    def _alloc_for(self, req: Request):
        """The request's PageTable: a prefix-cache hit charges only the
        unshared tail (+1 COW page when the whole prompt matched — the
        bootstrap decode rewrites the last prompt position); a miss (or
        no cache) pays the full worst case, as always. Lookup refs are
        either installed in the table (retired with it) or released
        here when the tail allocation fails; a pool-blocked allocation
        retries once after shedding cold cache-only pages, so the cache
        can never starve live admissions."""
        ps = self.pool.page_size
        cache = self.prefix_cache
        match = cache.lookup(req.prompt) if cache is not None else None
        total = pages_needed(req.total_tokens, ps)
        matched = 0 if match is None else len(match.pages)
        need = total - matched + (1 if match is not None and match.full
                                  else 0)
        pages = self.pool.alloc(need)
        if pages is None and cache is not None and cache.reclaim(need):
            pages = self.pool.alloc(need)
        if pages is None:
            if match is not None:
                self.pool.free(match.pages)   # release the lookup refs
            return None
        table = PageTable(ps)
        if match is None:
            table.pages = pages
        elif match.full:
            table.pages = match.pages[:-1] + [pages[0]] + pages[1:]
            req.prefix_cow = (match.pages[-1], pages[0])
            req.prefix_match = match
        else:
            table.pages = match.pages + pages
            req.prefix_match = match
        return table

    def admit(self) -> list[Request]:
        """Admit queued requests into free slots in effective-priority
        order (tier after aging, FIFO within a tier) while the pool can
        cover their worst case; returns the newly admitted requests
        (the engine prefills them)."""
        out: list[Request] = []
        for i in range(self.num_slots):
            if self.slots[i] is not None:
                continue
            with self._lock:
                if not self.queue:
                    break
                head = self._pick_head(self.now())
                table = self._alloc_for(head)
                if table is None:
                    # the scheduler DECIDED to block admission: the
                    # reason belongs in the flight record, it is what a
                    # postmortem reader needs to explain a deep queue
                    _flight.record("serving", "admit_blocked",
                                   trace_id=head.trace_id,
                                   inst=self.inst, request=head.id,
                                   reason="pool_full",
                                   need_tokens=head.total_tokens)
                    break            # pool full: wait for evictions
                self.queue.remove(head)
                # slot assignment inside the SAME critical section as
                # the dequeue: a postmortem snapshot reading queue +
                # slots under this lock must never catch a request in
                # neither place
                head.table = table
                head.slot = i
                head.status = "running"
                head.started_at = self.now()
                self.slots[i] = head
            self._m_admitted.inc()
            _flight.record("serving", "admit", trace_id=head.trace_id,
                           inst=self.inst, request=head.id, slot=i,
                           pages=len(table.pages),
                           cached_pages=0 if head.prefix_match is None
                           else len(head.prefix_match.pages),
                           tier=head.priority, tenant=head.tenant)
            out.append(head)
        return out

    def record_token(self, req: Request, token: int) -> bool:
        """Append a sampled token; returns True when the request is now
        finished (EOS or max_new_tokens) and has been evicted."""
        req.generated.append(int(token))
        req.last_token_at = self.now()
        if req.first_token_at is None:
            req.first_token_at = req.last_token_at
        req.table.length = req.position + 1
        if (req.eos_id is not None and token == req.eos_id) \
                or len(req.generated) >= req.max_new_tokens:
            self.evict(req, "done")
            return True
        req._notify_progress()       # streaming consumers wake per token
        return False

    def cancel(self, req: Request) -> bool:
        """Abandon a queued or running request (its pages return to the
        pool; partial output stands). False if already finished. The
        caller must hold the engine step lock so this never races a
        decode step."""
        with self._lock:
            try:
                self.queue.remove(req)
            except ValueError:
                pass
        if req.done():
            return False
        # evict is idempotent: a concurrent shed that wins the race
        # makes this a no-op and cancel reports False
        return self.evict(req, "cancelled")

    def evict(self, req: Request, status: str) -> bool:
        if req.slot is not None and self.slots[req.slot] is req:
            self.slots[req.slot] = None
        finished = self._finish(req, status)
        if finished and status == "done":
            self._m_completed.inc()
        return finished

    def _finish(self, req: Request, status: str,
                reason: str | None = None) -> bool:
        """`status` is the request's public lifecycle state; `reason`
        (default: the status) is the finer-grained eviction label —
        e.g. a queued deadline lapse finishes with status "deadline"
        but reason "expired_in_queue". Idempotent: the shed path runs
        on the submitting thread OUTSIDE the engine step lock, so it
        can race a concurrent cancel — first caller wins, the loser
        is a no-op (returns False)."""
        with self._lock:
            if req._finished:
                return False
            req._finished = True
        now = self.now()
        if req.prefix_cow is not None:
            # bootstrap admission that died before the engine's COW
            # copy: drop the pinned lookup ref on the source page
            self.pool.free([req.prefix_cow[0]])
            req.prefix_cow = None
        pages = 0
        if req.table is not None:
            if status == "done" and self.prefix_cache is not None:
                # retirement insert: publish prompt+generated pages so
                # a follow-up turn reuses this conversation's KV. The
                # LAST generated token's KV is never written (decode
                # writes token t's KV while generating t+1), hence the
                # total-1 page ceiling.
                total = int(req.prompt.size) + len(req.generated)
                n = min((total - 1) // self.pool.page_size,
                        len(req.table.pages))
                if n > 0:
                    toks = np.concatenate(
                        [req.prompt,
                         np.asarray(req.generated, np.int32)])
                    self.prefix_cache.insert(
                        toks[:n * self.pool.page_size],
                        req.table.pages[:n])
            pages = len(req.table.pages)   # before free() recycles them
            self.pool.free(req.table)
            req.table = None
        req.status = status
        req.finished_at = now
        # per-tenant accounting: what this request consumed reaching its
        # terminal state — queue wait, generated tokens, and the HBM it
        # held (pages × slot residency)
        queue_s = 0.0
        if req._queued_at is not None:
            queue_s = max(0.0, (req.started_at or now) - req._queued_at)
        kv_page_s = 0.0
        if req.started_at is not None:
            kv_page_s = pages * max(0.0, now - req.started_at)
        _meter.METER.note_outcome(req.tenant, req.priority,
                                  reason or status,
                                  tokens_out=len(req.generated),
                                  queue_s=queue_s, kv_page_s=kv_page_s)
        _EVICTIONS.labels(inst=self.inst,
                          reason=reason or status).inc()
        _flight.record("serving", "evict", trace_id=req.trace_id,
                       inst=self.inst, request=req.id,
                       reason=reason or status,
                       generated=len(req.generated))
        req._done.set()
        req._notify_progress()
        return True

    def drain(self):
        """Stop admitting (submit raises QueueFull); queued + running
        requests finish normally. One-way for this scheduler's life —
        a drained replica is retired or respawned, never un-drained."""
        with self._lock:
            self.draining = True
        _flight.record("serving", "drain", inst=self.inst,
                       queue_depth=len(self.queue))

    def stats(self) -> dict:
        return {"queue_depth": self.queue_depth,
                "active_slots": len(self.active_requests()),
                "num_slots": self.num_slots,
                "draining": self.draining,
                "admitted": self.admitted,
                "completed": self.completed,
                "preemptions": self.preemptions,
                "rejected": self.rejected,
                "expired_in_queue": self.expired_in_queue,
                "shed": self.shed,
                "quota_rejected": self.quota_rejected}
