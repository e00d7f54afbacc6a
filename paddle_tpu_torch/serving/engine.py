"""Serving engine: continuous-batching decode loop over a paged cache
(counterpart of ``paddle_tpu/serving/engine.py``).

One Engine = one model + one preallocated page pool + one fixed-shape
slot batch. Each scheduler iteration (`step()`):

  1. expire deadlines (queued + running; preempted requests free ALL
     their pages back to the pool immediately);
  2. admit queued requests into free slots (capacity-gated FIFO), run
     one PREFILL per admission (prompt KV -> pages, first token);
  3. run ONE DECODE over the whole slot batch (inactive slots ride along
     pointed at the trash page) and record each slot's token, evicting
     on EOS / max_new_tokens.

Bucket contract: decode runs one shape per (slots, pages) bucket — an
Engine has exactly one such bucket; prefill runs one shape per
prompt-length bucket (page-aligned power-of-two padding). PyTorch runs
eagerly, so nothing is traced: `stats()["compiles"]` keeps the JAX
engine's keys and counts the FIRST call of each bucket (the call that
builds kernels and warms the allocator).

Threading: `submit()` may be called from any number of frontend threads
(bounded queue = backpressure); the step loop runs either on the
caller's thread (`run_until_idle`, deterministic tests) or on the
engine's own scheduler thread (`start()`).
"""
from __future__ import annotations

import itertools
import math
import os
import threading
import time
import weakref
from collections import defaultdict, deque

import numpy as np

import torch

from ..distributed.fleet.runtime import fault_injection as _fi
from ..observability import (flight as _flight, meter as _meter,
                             perf as _perf, registry as _obs,
                             tracing as _tracing)
from .kv_cache import PagePool, defrag_plan
from .prefix_cache import PrefixCache
from .sampling import sample_tokens, seed_to_key
from .scheduler import QueueFull, Request, Scheduler

__all__ = ["Engine", "QueueFull"]

# engine telemetry (labeled per engine instance; the scheduler/pool
# series share the same label value). Hot-path writes are counter incs
# and histogram observes around the model calls — host-side
# microseconds against millisecond steps.
_REQS = _obs.counter(
    "paddle_tpu_serving_requests_total",
    "requests submitted to the engine", ["engine"])
_TOKENS = _obs.counter(
    "paddle_tpu_serving_tokens_total",
    "tokens generated (prefill first tokens + decode)", ["engine"],
    always=True)  # backs stats()["tokens_generated"]
_STEPS = _obs.counter(
    "paddle_tpu_serving_steps_total",
    "decode scheduler iterations that ran the slot batch", ["engine"],
    always=True)  # backs stats()["steps"]
_COMPILES = _obs.counter(
    "paddle_tpu_serving_compiles_total",
    "first calls per program bucket",
    ["engine", "bucket"])
_DECODE_H = _obs.histogram(
    "paddle_tpu_serving_decode_step_seconds",
    "wall time of one decode over the slot batch", ["engine"])
_PREFILL_H = _obs.histogram(
    "paddle_tpu_serving_prefill_seconds",
    "wall time of one prefill (admission)", ["engine"])
_LATENCY_H = _obs.histogram(
    "paddle_tpu_serving_request_latency_seconds",
    "submit-to-finish latency per request", ["engine"])
_QUEUE_DEPTH = _obs.gauge(
    "paddle_tpu_serving_queue_depth",
    "requests waiting for admission (live)", ["engine"])
_OCCUPANCY = _obs.gauge(
    "paddle_tpu_serving_page_occupancy",
    "fraction of KV pages in use (live)", ["engine"])
_SAMPLING_REQS = _obs.counter(
    "paddle_tpu_sampling_requests_total",
    "requests submitted with temperature > 0", ["engine"])
_SAMPLING_TOKENS = _obs.counter(
    "paddle_tpu_sampling_tokens_total",
    "tokens drawn from the Philox sampler (temperature > 0)",
    ["engine"])

_engine_ids = itertools.count()


def _drop_engine_series(eid: str):
    for m in (_REQS, _TOKENS, _STEPS, _COMPILES, _DECODE_H, _PREFILL_H,
              _LATENCY_H, _QUEUE_DEPTH, _OCCUPANCY, _SAMPLING_REQS,
              _SAMPLING_TOKENS):
        m.remove_matching(engine=eid)


def _bucket_len(n: int, page_size: int) -> int:
    """Smallest page-aligned power-of-two-pages length >= n."""
    pages = max(1, math.ceil(n / page_size))
    return page_size * (1 << (pages - 1).bit_length())


class Engine:
    def __init__(self, model, num_slots: int = 8, num_pages: int = 64,
                 page_size: int = 16, max_seq_len: int | None = None,
                 eos_id: int | None = None, max_queue: int = 256,
                 prefix_cache_pages: int | None = None):
        self.model = model
        self.device = model.device
        self.eos_id = eos_id
        self.page_size = page_size
        self.num_pages = num_pages
        # the hard sequence ceiling is min(pool capacity, requested cap,
        # MODEL position limit) — without the model term a request could
        # decode past wpe, where the embedding lookup raises mid-step
        model_cap = getattr(model, "max_positions", None)
        cap = min(max_seq_len or num_pages * page_size,
                  num_pages * page_size,
                  model_cap if model_cap else num_pages * page_size)
        # floor to a page multiple: prefill buckets are page-aligned and
        # must never pad past the model's position table
        if cap < page_size:
            raise ValueError(
                f"page_size {page_size} exceeds the sequence ceiling "
                f"{cap} (model/pool/max_seq_len)")
        self.max_seq_len = (cap // page_size) * page_size
        self.max_pages_per_req = max(
            1, min(num_pages, self.max_seq_len // page_size))
        self.num_slots = num_slots
        self.engine_id = f"e{next(_engine_ids)}"
        self.pool = PagePool(num_pages, page_size, inst=self.engine_id)
        self.scheduler = Scheduler(self.pool, num_slots, self.max_seq_len,
                                   max_queue=max_queue,
                                   inst=self.engine_id)
        self.trash_page = num_pages      # model pools carry P+1 pages
        self.cache = model.init_cache(num_pages, page_size)
        # shared-prefix KV reuse (serving/prefix_cache.py): 0 pages =
        # disabled (the default — an idle engine then provably holds no
        # pages)
        if prefix_cache_pages is None:
            prefix_cache_pages = int(os.environ.get(
                "PADDLE_TPU_PREFIX_CACHE_PAGES", "0") or 0)
        self.prefix_cache = None
        if prefix_cache_pages > 0:
            self.prefix_cache = PrefixCache(
                self.pool, budget_pages=min(prefix_cache_pages,
                                            num_pages),
                inst=self.engine_id)
            self.scheduler.prefix_cache = self.prefix_cache

        self._compiles: dict[str, int] = defaultdict(int)
        self._latencies: deque[float] = deque(maxlen=4096)
        self._tok_window: deque[tuple[float, int]] = deque(maxlen=512)
        # registry series for this engine (stats() reads these back)
        eid = self.engine_id
        self._m_reqs = _REQS.labels(engine=eid)
        self._m_tokens = _TOKENS.labels(engine=eid)
        self._m_steps = _STEPS.labels(engine=eid)
        self._m_decode_h = _DECODE_H.labels(engine=eid)
        self._m_prefill_h = _PREFILL_H.labels(engine=eid)
        self._m_latency_h = _LATENCY_H.labels(engine=eid)
        self._m_sampling_reqs = _SAMPLING_REQS.labels(engine=eid)
        self._m_sampling_tokens = _SAMPLING_TOKENS.labels(engine=eid)
        # live gauges read through a weakref so the registry never pins
        # a dead engine (tests build hundreds per process)
        wr = weakref.ref(self)
        _QUEUE_DEPTH.labels(engine=eid).set_function(
            lambda: (lambda e: e.scheduler.queue_depth if e else 0.0)(
                wr()))
        _OCCUPANCY.labels(engine=eid).set_function(
            lambda: (lambda e: e.pool.occupancy if e else 0.0)(wr()))
        # a dead engine's series (incl. the weakref gauges, which would
        # otherwise report 0.0 forever) leave the exposition
        weakref.finalize(self, _drop_engine_series, eid)
        self._lock = threading.Lock()    # step loop exclusivity
        self._stats_lock = threading.Lock()  # deque append vs snapshot
        # published-version identity; 0 = cold weights, warm_start
        # stamps the version it installs
        self.model_version = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        # the pools are updated in place; on a card a failed step may
        # leave them unusable (a sticky CUDA error, a half-written page),
        # so the engine rebuilds them like a TPU engine rebuilds a
        # donated buffer (_recover_cache). On the CPU a failed prefill
        # wrote only the failing request's own pages.
        self._rebuild_on_failure = self.device.type == "cuda"

        # perf plane: per-bucket analytic FLOPs land in
        # _register_perf_cost on each bucket's first call; a bounded
        # window of (time, flops) pairs backs the live MFU gauge the same
        # way _tok_window backs tokens_per_sec
        self.num_chips = 1               # single-chip engine today
        self._flops_window: deque[tuple[float, float]] = deque(maxlen=512)
        self._bucket_flops: dict[str, float] = {}
        self._perf_sampler = _perf.StepSampler(f"engine:{eid}")
        self._perf_name = f"engine:{eid}"
        _perf.mfu_gauge(self._perf_name).set_function(
            lambda: (lambda e: e.perf_rates()["mfu"] if e else 0.0)(wr()))
        _perf.kv_cache_gauge(eid).set_function(
            lambda: (lambda e: e._kv_cache_bytes() if e else 0.0)(wr()))
        _perf.register_provider(self._perf_name,
                                _perf.weak_provider(self, "perf_rates"))
        weakref.finalize(self, _perf.drop_instance, self._perf_name, eid)

    # -- submission (any thread) ---------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               deadline: float | None = None,
               eos_id: int | None = None, priority: int = 1,
               tenant: str = "default", temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               seed: int | None = None) -> Request:
        """Enqueue a request. `deadline` is RELATIVE seconds from now;
        raises QueueFull (backpressure) when the queue is at capacity
        and QuotaExceeded (a QueueFull) when `tenant` is over its
        token-bucket quota. `priority` is the admission tier
        (0 = highest; see scheduler.Scheduler). `temperature` 0 is
        greedy; > 0 samples via the replayable (seed, step) Philox
        stream (serving/sampling.py) — `seed` defaults to the request
        id, so an identical resubmission with an explicit seed (or the
        same wire id through the frontend) replays token-for-token."""
        req = Request(prompt, max_new_tokens,
                      deadline=None if deadline is None
                      else time.monotonic() + deadline,
                      eos_id=eos_id if eos_id is not None else self.eos_id,
                      priority=priority, tenant=tenant,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        if req.temperature > 0:
            self._m_sampling_reqs.inc()
        # carry the caller's trace context (e.g. the frontend handler's
        # wire trace id) onto the request — minting a fresh id for
        # in-process callers, so EVERY request's flight timeline is
        # keyed by a trace id even without a wire hop
        req.trace_id = _tracing.TRACER.current_trace_id() \
            or _tracing.new_trace_id()
        # offered load is metered even if the scheduler rejects below —
        # billing sees what the tenant *sent*, not what was admitted
        _meter.METER.note_submitted(req.tenant, req.priority,
                                    int(req.prompt.size))
        self.scheduler.submit(req)
        self._m_reqs.inc()
        _flight.record("serving", "submit", trace_id=req.trace_id,
                       engine=self.engine_id, request=req.id,
                       prompt_len=int(req.prompt.size),
                       max_new_tokens=req.max_new_tokens,
                       tier=req.priority, tenant=req.tenant)
        self._wake.set()
        return req

    def generate(self, prompt, max_new_tokens: int = 16,
                 deadline: float | None = None,
                 timeout: float | None = 120.0, priority: int = 1,
                 tenant: str = "default", temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: int | None = None) -> np.ndarray:
        """Blocking convenience: submit + wait (requires the scheduler
        thread running, or another thread driving step())."""
        return self.submit(prompt, max_new_tokens, deadline=deadline,
                           priority=priority, tenant=tenant,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed).result(timeout)

    # -- checkpoint warm-start ------------------------------------------
    def warm_start(self, root: str, step: int | None = None,
                   version: int | None = None):
        """Swap in weights from a committed checkpoint manifest
        (paddle_tpu_torch.checkpoint) without rebuilding the engine:
        shapes and dtypes must match the current model (the page pools
        and buckets stay valid).

        Two-phase so the swap is zero-downtime: the checkpoint read AND
        the host->device upload run off the step lock (decode keeps
        batching on the old weights through both), then the FLIP takes
        the lock for a single reference swap to a new parameter dict —
        weights change between steps, never inside one, and no step
        reads a half-copied tensor. The pools are untouched, so
        _recover_cache works after a flip as before.

        ``version`` stamps the published-version identity the flip
        installs (stats()["model_version"]); it defaults to ``step`` so
        a plain checkpoint warm start is still identifiable."""
        prepared = self.model.read_checkpoint(root, step=step)
        with self._lock:
            self.model.adopt_checkpoint(prepared)
            v = version if version is not None else step
            if v is not None:
                self.model_version = int(v)
        return self

    @classmethod
    def from_checkpoint(cls, root: str, step: int | None = None,
                        attn_impl: str | None = None, device=None,
                        **engine_kw) -> "Engine":
        """Build an Engine whose model (config + weights) comes from a
        checkpoint manifest — the serving cold-start path that skips
        drawing and uploading a random init. ``device`` is the model's
        (CUDA unless "cpu" is asked for); the rest goes to Engine."""
        from .model import GPTDecodeModel
        model = GPTDecodeModel.from_checkpoint(root, step=step,
                                               attn_impl=attn_impl,
                                               device=device)
        return cls(model, **engine_kw)

    # -- the three programs ------------------------------------------
    # sampling params ride every call as slot-wide tensors
    # (sampling.py): a greedy slot (temperature 0) still takes the
    # literal argmax path inside sample_tokens
    def _prefill(self, params, cache, tokens, true_len, page_row,
                 temps, topks, topps, seeds, steps):
        cache, logits = self.model.prefill(params, cache, tokens, true_len,
                                           page_row)
        tok = sample_tokens(logits[None, :], temps, topks, topps, seeds,
                            steps)
        return cache, tok[0]

    def _prefill_tail(self, params, cache, tokens, start, true_len,
                      page_row, temps, topks, topps, seeds, steps):
        cache, logits = self.model.prefill_tail(params, cache, tokens,
                                                start, true_len, page_row)
        tok = sample_tokens(logits[None, :], temps, topks, topps, seeds,
                            steps)
        return cache, tok[0]

    def _decode(self, params, cache, tokens, positions, tables, temps,
                topks, topps, seeds, steps):
        cache, logits = self.model.decode(params, cache, tokens, positions,
                                          tables)
        return cache, sample_tokens(logits, temps, topks, topps, seeds,
                                    steps)

    def _note_compile(self, bucket: str):
        """First call of a bucket (stats()["compiles"] keeps the JAX
        engine's keys; here a bucket is 'compiled' once: its first
        call builds kernels and warms the allocator)."""
        self._compiles[bucket] += 1
        _COMPILES.labels(engine=self.engine_id, bucket=bucket).inc()
        _flight.record("serving", "compile", engine=self.engine_id,
                       bucket=bucket)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device (uint32 seeds
        travel as int64, the sampler's lane type)."""
        if arr.dtype == np.uint32:
            arr = arr.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- step loop -----------------------------------------------------
    def _row(self, req: Request | None) -> list[int]:
        if req is None:
            return [self.trash_page] * self.max_pages_per_req
        return req.table.padded(self.max_pages_per_req,
                                fill=self.trash_page)

    def _req_sampling(self, req: Request):
        """Shape-[1] sampling args for the prefill programs."""
        seed = req.seed if req.seed is not None else req.id
        return (np.asarray([req.temperature], np.float32),
                np.asarray([req.top_k], np.int32),
                np.asarray([req.top_p], np.float32),
                seed_to_key(seed).reshape(1, 2),
                np.asarray([len(req.generated)], np.int32))

    def _apply_cow(self, req: Request):
        """Full-prompt bootstrap admission: copy the last matched page
        (the decode step will rewrite the last prompt position's KV
        there) into the request's private page, then drop the lookup
        ref the scheduler kept pinned for exactly this copy."""
        src, dst = req.prefix_cow
        self.cache = self.model.copy_pages(self.cache, [src], [dst])
        req.prefix_cow = None
        self.pool.free([src])
        if self.prefix_cache is not None:
            self.prefix_cache.note_cow()
        _flight.record("serving", "prefix_cow", trace_id=req.trace_id,
                       engine=self.engine_id, request=req.id,
                       src=src, dst=dst)

    def _cache_insert_prompt(self, req: Request):
        """Publish the freshly prefilled prompt's full pages (existing
        cached prefixes dedupe inside insert)."""
        if self.prefix_cache is None:
            return
        n = int(req.prompt.size) // self.page_size
        if n:
            self.prefix_cache.insert(req.prompt[:n * self.page_size],
                                     req.table.pages[:n])

    def _run_prefill(self, req: Request):
        if req.prefix_cow is not None:
            self._apply_cow(req)
        m = req.prefix_match
        if m is not None and m.full:
            # bootstrap: the WHOLE prompt was cached — no prefill at
            # all. The request enters the decode batch with no
            # generated tokens; the next decode step feeds the last
            # prompt token at position prompt_len-1 (re-deriving that
            # position's KV into the COW page) and samples the first
            # token there.
            _flight.record("serving", "prefill_skipped",
                           trace_id=req.trace_id, engine=self.engine_id,
                           request=req.id,
                           cached_tokens=m.tokens)
            return
        start = m.tokens if m is not None else 0
        tail = req.prompt[start:] if start else req.prompt
        T = _bucket_len(tail.size, self.page_size)
        T = min(T, self.max_pages_per_req * self.page_size - start)
        toks = np.zeros((T,), np.int32)
        toks[:tail.size] = tail
        row = self._dev(np.asarray(self._row(req), np.int32))
        samp = tuple(self._dev(a) for a in self._req_sampling(req))
        if start:
            bucket = f"prefill_tail[{T}]"
            fn = self._prefill_tail
            targs = (self.model.params, self.cache, self._dev(toks),
                     start, int(tail.size), row, *samp)
        else:
            bucket = f"prefill[{T}]"
            fn = self._prefill
            targs = (self.model.params, self.cache, self._dev(toks),
                     int(tail.size), row, *samp)
        first = bucket not in self._compiles
        if first:
            self._note_compile(bucket)
            self._register_perf_cost(bucket, T, start + T)
        t0 = time.perf_counter()
        with _tracing.span("engine.prefill", trace_id=req.trace_id,
                           engine=self.engine_id, request=req.id,
                           prompt_len=int(req.prompt.size), bucket=T,
                           cached_tokens=start):
            self.cache, tok = fn(*targs)
            tok = int(tok)      # waits for the device
        dt = time.perf_counter() - t0
        self._m_prefill_h.observe(dt)
        if first:
            _perf.note_compile_seconds("engine.prefill", dt)
        self._note_flops(self._bucket_flops.get(bucket))
        _flight.record("serving", "prefill", trace_id=req.trace_id,
                       engine=self.engine_id, request=req.id,
                       bucket=T, seconds=round(dt, 6))
        self._cache_insert_prompt(req)
        self._note_tokens(1)
        if req.temperature > 0:
            self._m_sampling_tokens.inc()
        if self.scheduler.record_token(req, tok):
            self._note_done(req)

    def step(self) -> bool:
        """One scheduler iteration; returns True if any work was done."""
        with self._lock:
            for r in self.scheduler.expire_deadlines():
                self._note_done(r)
            for req in self.scheduler.admit():
                try:
                    self._run_prefill(req)
                except Exception as e:
                    # a poison request fails ALONE: evict it with its
                    # pages, keep the engine serving everyone else
                    req.error = f"prefill failed: {type(e).__name__}: {e}"
                    self.scheduler.evict(req, "error")
                    self._note_done(req)
                    self._recover_cache("failed prefill")
            active = [(i, r) for i, r in enumerate(self.scheduler.slots)
                      if r is not None]
            if not active:
                return bool(self.scheduler.queue_depth)
            sample = self._perf_sampler.tick()
            t_host0 = time.perf_counter()
            S = self.num_slots
            tokens = np.zeros((S,), np.int32)
            positions = np.zeros((S,), np.int32)
            tables = np.full((S, self.max_pages_per_req), self.trash_page,
                             np.int32)
            temps = np.zeros((S,), np.float32)
            topks = np.zeros((S,), np.int32)
            topps = np.ones((S,), np.float32)
            seeds = np.zeros((S, 2), np.uint32)
            steps = np.zeros((S,), np.int32)
            sampled_n = 0
            for i, r in active:
                # a bootstrap admission (whole prompt cached, prefill
                # skipped) reaches its first decode with NOTHING
                # generated: feed the last prompt token at position
                # prompt_len-1, exactly where prefill would have left it
                tokens[i] = r.generated[-1] if r.generated \
                    else int(r.prompt[-1])
                positions[i] = r.position
                tables[i] = self._row(r)
                temps[i] = r.temperature
                topks[i] = r.top_k
                topps[i] = r.top_p
                seeds[i] = seed_to_key(r.seed if r.seed is not None
                                       else r.id)
                steps[i] = len(r.generated)
                if r.temperature > 0:
                    sampled_n += 1
            # hang injection (chaos drills): PADDLE_PS_FAULT_STALL with
            # PADDLE_PS_FAULT_STALL_POINT=serving_decode wedges the step
            # thread here — inside the step lock, like a hung decode —
            # while requests keep queueing
            _fi.injector().maybe_stall("serving_decode")
            bucket = f"decode[slots={S},pages={self.max_pages_per_req}]"
            targs = (self.model.params, self.cache, self._dev(tokens),
                     self._dev(positions), self._dev(tables),
                     self._dev(temps), self._dev(topks), self._dev(topps),
                     self._dev(seeds), self._dev(steps))
            first = bucket not in self._compiles
            if first:
                self._note_compile(bucket)
                self._register_perf_cost(bucket, S, self.max_seq_len)
            try:
                t0 = time.perf_counter()
                with _tracing.span("engine.decode",
                                   engine=self.engine_id,
                                   active=len(active)):
                    self.cache, device_toks = self._decode(*targs)
                    if sample:
                        # fenced phase boundaries: dispatch ends when
                        # the asynchronous launches return, device when
                        # the card is done, transfer when the tokens
                        # are host-side
                        t1 = time.perf_counter()
                        self._sync()
                        t2 = time.perf_counter()
                        next_toks = device_toks.cpu().numpy()
                        t3 = time.perf_counter()
                    else:
                        next_toks = device_toks.cpu().numpy()
                dt = time.perf_counter() - t0
                self._m_decode_h.observe(dt)
            except Exception as e:
                # a decode-step failure poisons the whole slot batch (the
                # pools may be half-written): fail the in-flight requests
                # with their pages freed rather than wedging them
                for _i, r in active:
                    r.error = f"decode failed: {type(e).__name__}: {e}"
                    self.scheduler.evict(r, "error")
                    self._note_done(r)
                self._recover_cache("failed decode")
                raise
            if first:
                _perf.note_compile_seconds("engine.decode", dt)
            elif sample:
                # host = batch building (token/position/table arrays);
                # dispatch = the launches returning; device = the
                # synchronize fence; transfer = device->host copy
                _perf.record_breakdown(self._perf_name, {
                    "host": t0 - t_host0,
                    "dispatch": t1 - t0,
                    "device": t2 - t1,
                    "transfer": t3 - t2,
                })
            self._note_tokens(len(active))
            if sampled_n:
                self._m_sampling_tokens.inc(sampled_n)
            self._note_flops(self._bucket_flops.get(bucket))
            self._m_steps.inc()
            _flight.record("serving", "step", engine=self.engine_id,
                           active=len(active))
            for i, r in active:
                if self.scheduler.record_token(r, int(next_toks[i])):
                    self._note_done(r)
            return True

    def _recover_cache(self, why: str):
        """After a failed step on a card the in-place pools may be
        unusable — rebuild them and fail whatever in-flight KV they
        held (on the CPU a failed prefill wrote only its own pages, so
        surviving requests keep decoding)."""
        if not self._rebuild_on_failure:
            return
        for r in list(self.scheduler.active_requests()):
            r.error = f"kv cache lost to a {why} (pools rebuilt)"
            self.scheduler.evict(r, "error")
            self._note_done(r)
        self.cache = self.model.init_cache(self.num_pages, self.page_size)

    def drain(self) -> "Engine":
        """Graceful removal from a serving fleet: stop admitting new
        requests (submit raises QueueFull("draining")), let everything
        queued or running finish. `stats()["draining"]` and the
        frontend's `ping` report it so a router stops routing here;
        `run_until_idle`/the scheduler thread empty the queue, then the
        process can exit with nothing lost."""
        self.scheduler.drain()
        self._wake.set()
        return self

    @property
    def draining(self) -> bool:
        return self.scheduler.draining

    def cancel(self, req: Request) -> bool:
        """Abandon a request (frontend timeout, client gone): dequeue or
        preempt it, freeing its pages. False if it already finished."""
        with self._lock:
            return self.scheduler.cancel(req)

    def run_until_idle(self, max_steps: int = 100000):
        for _ in range(max_steps):
            self.step()
            if self.scheduler.idle:
                return
        raise RuntimeError(f"not idle after {max_steps} steps")

    def defrag(self):
        """Compact live pages to the low end of the pool (between steps).
        Shared pages move once; every holder — tables, the prefix
        cache's runs, and any pending COW source — is rewritten through
        the same mapping."""
        with self._lock:
            active = list(self.scheduler.active_requests())
            tables = [r.table for r in active]
            extra = self.prefix_cache.pages() if self.prefix_cache \
                else ()
            mapping = defrag_plan(self.pool, tables, extra_pages=extra)
            if self.prefix_cache is not None:
                self.prefix_cache.remap(mapping)
            for r in active:
                if r.prefix_cow is not None:
                    src, dst = r.prefix_cow
                    r.prefix_cow = (mapping.get(src, src),
                                    mapping.get(dst, dst))
            self.cache = self.model.apply_defrag(self.cache, mapping)
            return mapping

    # -- background thread ---------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    worked = self.step()
                except Exception:
                    # step() already failed the affected requests; the
                    # serving thread must survive a poison step or every
                    # later request wedges against a dead engine
                    import traceback
                    traceback.print_exc()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                if not worked and self.scheduler.idle:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- perf plane ----------------------------------------------------
    def _register_perf_cost(self, bucket: str, tokens: int, ctx: int):
        """First call of a bucket: register its analytic matmul FLOPs
        under (serving:<eid>, bucket) — eager PyTorch has no compiler
        cost analysis to read."""
        fl = _perf.register_cost(
            f"serving:{self.engine_id}", bucket,
            _perf.analytic_gpt_flops(getattr(self.model, "cfg", None),
                                     tokens, ctx))
        if fl:
            self._bucket_flops[bucket] = fl

    def _note_flops(self, flops: float | None):
        if flops:
            with self._stats_lock:
                self._flops_window.append((time.monotonic(), flops))

    def _kv_cache_bytes(self) -> float:
        return float(sum(t.numel() * t.element_size()
                         for t in self.cache.values()))

    def perf_rates(self) -> dict:
        """Cheap live rates for ping/stats and the perf snapshot: no
        latency sort, two deque copies under the stats lock."""
        with self._stats_lock:
            w = list(self._tok_window)
            fw = list(self._flops_window)
        tps = 0.0
        if len(w) >= 2 and w[-1][0] > w[0][0]:
            tps = sum(n for _, n in w[1:]) / (w[-1][0] - w[0][0])
        mfu = 0.0
        if len(fw) >= 2 and fw[-1][0] > fw[0][0]:
            flops_per_s = sum(f for _, f in fw[1:]) / (fw[-1][0] - fw[0][0])
            mfu = _perf.mfu(flops_per_s, 1.0)
        return {"tokens_per_sec": round(tps, 2),
                "tokens_per_s_per_chip": round(tps / self.num_chips, 2),
                "mfu": round(mfu, 5)}

    # -- stats ---------------------------------------------------------
    def _note_tokens(self, n: int):
        self._m_tokens.inc(n)
        with self._stats_lock:
            self._tok_window.append((time.monotonic(), n))

    def _req_flops(self, req: Request) -> float:
        """Metering-grade FLOPs estimate for one finished request from
        the analytic cost registry: its prefill bucket's cost plus a
        per-token share of the decode bucket (a decode step's cost
        amortizes over the slot batch it ran with)."""
        if req.started_at is None:
            return 0.0          # never admitted — nothing executed
        T = _bucket_len(int(req.prompt.size), self.page_size)
        T = min(T, self.max_pages_per_req * self.page_size)
        total = self._bucket_flops.get(f"prefill[{T}]", 0.0)
        decode_toks = max(0, len(req.generated) - 1)
        if decode_toks:
            shares = []
            for bucket, fl in self._bucket_flops.items():
                if bucket.startswith("decode[slots="):
                    s = bucket[len("decode[slots="):].split(",", 1)[0]
                    try:
                        shares.append(fl / max(1, int(s)))
                    except ValueError:
                        pass
            if shares:
                total += decode_toks * (sum(shares) / len(shares))
        return total

    def _note_done(self, req: Request):
        lat = req.latency()
        if lat is not None:
            self._m_latency_h.observe(lat)
            with self._stats_lock:
                self._latencies.append(lat)
        _meter.METER.note_flops(req.tenant, req.priority,
                                self._req_flops(req))

    def stats(self) -> dict:
        """/stats counters: queue depth, latency percentiles, tokens/sec,
        page-pool occupancy, preemptions, compiles per bucket."""
        with self._stats_lock:  # the step thread appends concurrently
            lats = sorted(self._latencies)
            w = list(self._tok_window)
        total = int(self._m_tokens.value)

        def pct(p):
            if not lats:
                return None
            return round(lats[min(len(lats) - 1,
                                  int(p / 100 * len(lats)))] * 1e3, 3)

        tps = 0.0
        if len(w) >= 2 and w[-1][0] > w[0][0]:
            tps = sum(n for _, n in w[1:]) / (w[-1][0] - w[0][0])
        rates = self.perf_rates()
        return {**self.scheduler.stats(),
                "pool": self.pool.stats(),
                "prefix_cache": self.prefix_cache.stats()
                if self.prefix_cache is not None else None,
                "model_version": self.model_version,
                "steps": int(self._m_steps.value),
                "tokens_generated": total,
                "tokens_per_sec": round(tps, 2),
                "tokens_per_s_per_chip": rates["tokens_per_s_per_chip"],
                "mfu": rates["mfu"],
                "latency_ms_p50": pct(50), "latency_ms_p99": pct(99),
                "completed_seen": len(lats),
                "compiles": dict(self._compiles)}
