"""Fleet telemetry collector: cross-process trace assembly + tail
sampling + the state behind the live dashboard (counterpart of
``paddle_tpu/observability/collector.py``: the same verbs, the same
keep decision for a trace id, the same assembled waterfall).

Per-process ``TelemetryAgent``s (``observability.agent``) stream
span/flight/metric/event batches here as ``tel_push`` calls over the
mux RPC wire. The ``TelemetryCollector``:

  * **assembles cross-process traces** keyed by the trace id that
    already rides the RPC skeleton (``_trace_id``): every span batch
    is bucketed by trace id, each process's ``time.monotonic`` span
    clocks are mapped onto the collector's wall clock via the agent's
    anchor (wall - monotonic) plus a clock-skew offset measured from
    ``tel_ping`` RTT midpoints (smallest RTT wins) — one request
    becomes ONE waterfall frontend -> engine -> PS;
  * applies **tail-based sampling** at trace completion (quiescence
    past ``PADDLE_TPU_TELEMETRY_LINGER``): error / deadline-missed /
    watchdog-flagged traces are kept 100%, anything above the moving
    p99 duration of recent traces is kept, and the boring rest is kept
    at rate ``PADDLE_TPU_TELEMETRY_SAMPLE`` (decided by a hash of the
    trace id — deterministic across restarts). Kept traces live in a
    bounded ring (``PADDLE_TPU_TELEMETRY_RING``); sampled-out and
    evicted traces are counted, never silently gone;
  * tracks **fleet state** per process (role, liveness, drop counts,
    latest metric snapshot, recent watchdog/bundle events) — the feed
    behind ``tel_fleet`` / ``tel_watch``. Processes that
    stop reporting past ``PADDLE_TPU_TELEMETRY_RETIRE`` are aged out
    (counted in ``paddle_tpu_telemetry_procs_retired_total``), so the
    fleet table shows the live fleet, not every process ever seen;
  * hosts the **time-series plane**: every push's fleet summary and
    every ride-along registry dump land in an embedded TSDB
    (``observability.timeseries`` — durable when
    ``PADDLE_TPU_TSDB_DIR`` is set, queryable via the ``tsdb_query``
    verb) and an alert engine
    (``observability.alerts``) evaluates burn-rate/threshold/absence
    rules over it on a cadence (``alerts`` verb),
    with per-tenant usage aggregation behind ``usage_report``;
  * exports any assembled trace as one merged **Chrome trace** with
    per-rank pid labels (``merge_chrome_traces`` is shared with the
    offline ``python -m paddle_tpu_torch.observability.registry <dir>``
    aggregator).

Hosting: ``telemetry_dispatch(collector, req)`` is the ``tel_*`` verb
switch, delegated from the PS dispatch exactly like the ``pub_*``
verbs (``PADDLE_TPU_TELEMETRY_HOST=1``), or served standalone by
``CollectorServer`` (the launcher's ``--telemetry`` runs
``python -m paddle_tpu_torch.observability.collector``).
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import OrderedDict, deque

from . import alerts as _alerts
from . import meter as _meter
from . import registry as _obs
from . import timeseries as _ts

__all__ = ["TelemetryCollector", "telemetry_dispatch", "TEL_READ_OPS",
           "CollectorServer", "merge_chrome_traces", "main"]

# tel_* verbs never need replay dedup: pushes are single-attempt
# fire-and-forget, everything else is a read. tsdb_query / alerts /
# usage_report are the time-series plane's read verbs — hosted by the
# same dispatch, gated into the hosting server's READ_OPS by this set
TEL_READ_OPS = frozenset({"tel_push", "tel_ping", "tel_fleet",
                          "tel_trace", "tel_traces", "tel_stats",
                          "tel_watch",
                          "tsdb_query", "alerts", "usage_report"})

_PUSHES = _obs.counter(
    "paddle_tpu_telemetry_push_batches_total",
    "tel_push batches ingested by the collector")
_SPANS = _obs.counter(
    "paddle_tpu_telemetry_spans_total",
    "spans ingested by the collector")
_TRACES = _obs.counter(
    "paddle_tpu_telemetry_traces_total",
    "traces finalized by the collector, by tail-sampling verdict",
    ["verdict"])
_EVICTED = _obs.counter(
    "paddle_tpu_telemetry_trace_evicted_total",
    "kept traces evicted from the bounded retention ring")
_RETIRED = _obs.counter(
    "paddle_tpu_telemetry_procs_retired_total",
    "processes aged out of the fleet table after the liveness window")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------------------
# shared Chrome-trace merging (collector export + offline registry CLI)
# ---------------------------------------------------------------------------

def merge_chrome_traces(parts) -> dict:
    """Merge per-rank Chrome ``traceEvents`` lists into ONE document.

    ``parts``: iterable of ``(label, events)`` — one entry per rank.
    Events keep their own tids but are re-pidded onto a dense per-rank
    pid with a ``process_name`` metadata row, so Perfetto shows one
    labeled track group per rank instead of colliding raw pids."""
    out = []
    for i, (label, events) in enumerate(parts):
        pid = i + 1
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": str(label)}})
        for ev in events:
            ev = dict(ev)
            ev["pid"] = pid
            out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _hist_quantile(buckets, cumulative, q: float) -> float | None:
    """Nearest-bucket quantile from a cumulative histogram snapshot
    (upper bound of the first bucket reaching rank q)."""
    if not cumulative or cumulative[-1] <= 0:
        return None
    rank = q * cumulative[-1]
    for i, c in enumerate(cumulative):
        if c >= rank:
            return float(buckets[i]) if i < len(buckets) \
                else float(buckets[-1])
    return float(buckets[-1])


class _TraceBuild:
    """One in-assembly trace: spans/flight per process, flags."""

    __slots__ = ("spans", "flight", "procs", "first", "last",
                 "error", "flagged")

    def __init__(self, now: float):
        self.spans: list[dict] = []
        self.flight: list[dict] = []
        self.procs: set = set()
        self.first = now           # collector monotonic
        self.last = now
        self.error = False
        self.flagged = False       # watchdog-flagged


_ERROR_REASONS = ("error", "deadline", "timeout", "failed")


def _span_error(sp: dict) -> bool:
    a = sp.get("attrs") or {}
    if "error" in a:
        return True
    st = str(a.get("status", "")).lower()
    return any(r in st for r in ("error", "deadline"))


def _flight_error(ev: dict) -> bool:
    if str(ev.get("kind", "")).endswith("_error"):
        return True
    a = ev.get("attrs") or {}
    reason = str(a.get("reason", "")).lower()
    return reason in _ERROR_REASONS or "error" in a


class TelemetryCollector:
    """See module docstring. Thread-safe; sweeping (trace completion +
    tail sampling) runs inline on ingest/read calls — no thread of its
    own, so hosting it on a PS dispatch costs nothing extra."""

    def __init__(self, sample: float | None = None,
                 ring_max: int | None = None,
                 linger_s: float | None = None,
                 reservoir: int = 512, events_max: int = 64,
                 tsdb: "_ts.TimeSeriesDB | None" = None,
                 alerts: "_alerts.AlertManager | None" = None,
                 retire_s: float | None = None):
        if sample is None:
            sample = _env_float("PADDLE_TPU_TELEMETRY_SAMPLE", 0.1)
        if ring_max is None:
            ring_max = int(_env_float("PADDLE_TPU_TELEMETRY_RING", 512))
        if linger_s is None:
            linger_s = _env_float("PADDLE_TPU_TELEMETRY_LINGER", 1.0)
        if retire_s is None:
            retire_s = _env_float("PADDLE_TPU_TELEMETRY_RETIRE", 120.0)
        self.sample = min(1.0, max(0.0, float(sample)))
        self.ring_max = max(1, int(ring_max))
        self.linger_s = max(0.0, float(linger_s))
        self.retire_s = max(0.0, float(retire_s))  # 0 disables GC
        self._lock = threading.RLock()
        # (host, pid) -> process record (fleet state)
        self._procs: dict[tuple, dict] = {}
        self._open: dict[str, _TraceBuild] = {}
        self._kept: OrderedDict[str, dict] = OrderedDict()
        self._durs: deque = deque(maxlen=max(32, int(reservoir)))
        self._recent_events: deque = deque(maxlen=max(8, events_max))
        self.counts = {"batches": 0, "spans": 0, "assembled": 0,
                       "kept_error": 0, "kept_slow": 0,
                       "kept_sampled": 0, "sampled_out": 0,
                       "evicted": 0, "procs_retired": 0,
                       "tsdb_errors": 0}
        self._started = time.time()
        # time-series plane: memory-only TSDB unless PADDLE_TPU_TSDB_DIR
        # points at a data dir; PADDLE_TPU_TSDB=0 turns the whole plane
        # off (the bench A/B toggle)
        if tsdb is None \
                and os.environ.get("PADDLE_TPU_TSDB", "1") != "0":
            tsdb = _ts.TimeSeriesDB()
        self.tsdb = tsdb
        if alerts is None and self.tsdb is not None \
                and os.environ.get("PADDLE_TPU_ALERTS", "1") != "0":
            alerts = _alerts.AlertManager(
                tsdb=self.tsdb, fleet_fn=self.fleet,
                event_cb=self._note_alert_event)
        self.alerts = alerts

    def _note_alert_event(self, ev: dict):
        """AlertManager transition tap: alert lifecycle shows up in the
        fleet's recent-events feed even when no
        local agent is armed. Called OUTSIDE the alert manager's lock."""
        rec = {"host": socket.gethostname(), "pid": os.getpid(),
               "role": "collector", "wall": time.time(),
               "kind": str(ev.get("kind", "?")),
               "attrs": ev.get("attrs") or {}}
        with self._lock:
            self._recent_events.append(rec)

    def close(self):
        if self.tsdb is not None:
            self.tsdb.close()

    # -- ingest (tel_push) ---------------------------------------------
    def ingest(self, batch: dict) -> dict:
        now = time.monotonic()
        key = (str(batch.get("host", "?")), int(batch.get("pid", 0)))
        offset = float(batch.get("offset") or 0.0)
        anchor = float(batch.get("anchor") or 0.0)
        spans = batch.get("spans") or ()
        flights = batch.get("flight") or ()
        events = batch.get("events") or ()
        with self._lock:
            proc = self._procs.get(key)
            if proc is None:
                proc = self._procs[key] = {
                    "host": key[0], "pid": key[1],
                    "role": str(batch.get("role") or "?"),
                    "events": deque(maxlen=32),
                    "prev_requests": None, "summary": {}}
            proc["role"] = str(batch.get("role") or proc["role"])
            proc["last_seen"] = time.time()
            proc["offset"] = offset
            proc["rtt"] = batch.get("rtt")
            proc["dropped"] = dict(batch.get("dropped") or {})
            self.counts["batches"] += 1
            _PUSHES.inc()
            for sp in spans:
                tid = sp.get("trace_id")
                if not tid:
                    continue
                tb = self._open.get(tid)
                if tb is None:
                    if tid in self._kept:
                        continue  # late span after finalize
                    tb = self._open[tid] = _TraceBuild(now)
                sp = dict(sp)
                # agent monotonic -> collector wall
                start = float(sp.get("start") or 0.0)
                end = float(sp.get("end") or start)
                sp["t0"] = start + anchor + offset
                sp["t1"] = end + anchor + offset
                sp["host"], sp["pid"] = key
                sp["role"] = proc["role"]
                tb.spans.append(sp)
                tb.procs.add(key)
                tb.last = now
                if _span_error(sp):
                    tb.error = True
                self.counts["spans"] += 1
                _SPANS.inc()
            for ev in flights:
                tid = ev.get("trace_id")
                err = _flight_error(ev)
                if tid and tid in self._open:
                    tb = self._open[tid]
                    ev = dict(ev)
                    ev["host"], ev["pid"] = key
                    tb.flight.append(ev)
                    tb.last = now
                    if err:
                        tb.error = True
            for ev in events:
                rec = {"host": key[0], "pid": key[1],
                       "role": proc["role"],
                       "wall": ev.get("wall"),
                       "kind": str(ev.get("kind", "?")),
                       "attrs": ev.get("attrs") or {}}
                proc["events"].append(rec)
                self._recent_events.append(rec)
                if rec["kind"].startswith("watchdog"):
                    # a stalled process taints every trace it still
                    # has in assembly — keep them all
                    for tb in self._open.values():
                        if key in tb.procs:
                            tb.flagged = True
            metrics = batch.get("metrics")
            if metrics is not None:
                proc["metrics"] = metrics
                proc["summary"] = self._summarize(proc, metrics)
            role = proc["role"]
            summary = dict(proc.get("summary") or {})
            self._sweep_locked(now)
        # TSDB ingest runs outside the collector lock: block seals do
        # disk IO and the TSDB has its own lock
        if self.tsdb is not None:
            try:
                if metrics is not None:
                    self.tsdb.ingest_dump(key[0], key[1], role, metrics)
                scal = {f"paddle_tpu_fleet_{k}": v
                        for k, v in summary.items()
                        if isinstance(v, (int, float))}
                if scal:
                    self.tsdb.ingest_scalars(
                        time.time(), scal,
                        {"host": key[0], "pid": str(key[1]),
                         "role": role})
            except Exception:
                with self._lock:
                    self.counts["tsdb_errors"] += 1
        if self.alerts is not None:
            self.alerts.maybe_evaluate()
        return {"ok": True}

    # -- fleet summary ---------------------------------------------------
    def _summarize(self, proc: dict, dump: dict) -> dict:
        by_name = {m["name"]: m for m in dump.get("metrics", ())}

        def total(name):
            m = by_name.get(name)
            if not m:
                return None
            return sum((s.get("value") or 0.0) for s in m["samples"])

        def quantiles(name, qs=(0.5, 0.99)):
            m = by_name.get(name)
            if not m or not m.get("samples"):
                return None
            buckets = m.get("buckets") or ()
            cum = [0] * (len(buckets) + 1)
            for s in m["samples"]:
                cum = [a + b for a, b in
                       zip(cum, s.get("cumulative") or cum)]
            return [_hist_quantile(buckets, cum, q) for q in qs]

        out = {}
        req = total("paddle_tpu_serving_requests_total")
        if req is not None:
            out["requests_total"] = req
            prev = proc.get("prev_requests")
            now = time.time()
            if prev is not None and now > prev[1]:
                out["rps"] = max(0.0, (req - prev[0]) / (now - prev[1]))
            proc["prev_requests"] = (req, now)
        for key_, name in (("queue_depth",
                            "paddle_tpu_serving_queue_depth"),
                           ("page_occupancy",
                            "paddle_tpu_serving_page_occupancy")):
            v = total(name)
            if v is not None:
                out[key_] = v
        for key_, name in (("ttft", "paddle_tpu_slo_ttft_seconds"),
                           ("itl", "paddle_tpu_slo_inter_token_seconds"),
                           ("latency",
                            "paddle_tpu_serving_request_latency_seconds")):
            q = quantiles(name)
            if q and q[0] is not None:
                out[f"{key_}_p50"], out[f"{key_}_p99"] = q
        pushes = total("paddle_tpu_ps_push_rows_total") \
            or total("paddle_tpu_rpc_server_requests_total")
        if pushes is not None:
            out["server_requests_total"] = pushes

        def by_labels(name, *keys):
            m = by_name.get(name)
            if not m:
                return {}
            return {"/".join(str(s["labels"].get(k, "")) for k in keys):
                    s.get("value") for s in m.get("samples", ())
                    if s.get("value") is not None}

        # perf plane: per-loop MFU, last sampled step breakdown,
        # compile counts, device memory + KV bytes, per process
        perf = {}
        mfu = by_labels("paddle_tpu_perf_mfu", "name")
        if mfu:
            perf["mfu"] = mfu
        bd = by_labels("paddle_tpu_perf_step_breakdown_seconds",
                       "name", "phase")
        if bd:
            perf["breakdown"] = bd
        compiles = total("paddle_tpu_serving_compiles_total")
        ecompiles = total("paddle_tpu_executor_compiles_total")
        if compiles or ecompiles:
            perf["compiles_total"] = (compiles or 0.0) + (ecompiles or 0.0)
        hbm = by_labels("paddle_tpu_perf_hbm_bytes", "kind")
        if any(hbm.values()):
            perf["hbm"] = hbm
        kv = total("paddle_tpu_perf_kv_cache_bytes")
        if kv:
            perf["kv_cache_bytes"] = kv
        kern = by_labels("paddle_tpu_autobench_candidate_ms",
                         "key", "candidate")
        if kern:
            perf["kernel_ms"] = kern
        if perf:
            out["perf"] = perf
        # tiered PS store: per-tier hits and
        # residency, faults/demotions, by-tier pull latency — what the
        # per PS shard
        tier = {}
        hits = by_labels("paddle_tpu_ps_tier_hits_total", "tier")
        if hits:
            tier["hits"] = hits
        rows = by_labels("paddle_tpu_ps_tier_resident_rows", "tier")
        if any(rows.values()):
            tier["resident_rows"] = rows
            tier["resident_bytes"] = by_labels(
                "paddle_tpu_ps_tier_resident_bytes", "tier")
        for key_, name in (("faults",
                            "paddle_tpu_ps_tier_faults_total"),
                           ("demotions",
                            "paddle_tpu_ps_tier_demotions_total"),
                           ("cold_read_errors",
                            "paddle_tpu_ps_tier_cold_read_errors_total")):
            v = total(name)
            if v:
                tier[key_] = v
        q = quantiles("paddle_tpu_ps_tier_pull_seconds")
        if q and q[0] is not None:
            tier["pull_p50"], tier["pull_p99"] = q
        if tier:
            out["tier"] = tier
        # shared-prefix KV cache + stochastic decode:
        # hit ratio, prefill tokens the cache absorbed, COW/eviction
        # churn and residency
        prefix = {}
        hits_ = total("paddle_tpu_prefix_lookup_hits_total")
        misses_ = total("paddle_tpu_prefix_lookup_misses_total")
        if hits_ or misses_:
            prefix["lookups"] = (hits_ or 0.0) + (misses_ or 0.0)
            prefix["hit_ratio"] = (hits_ or 0.0) / prefix["lookups"]
        for key_, name in (
                ("tokens_saved",
                 "paddle_tpu_prefix_prefill_tokens_saved_total"),
                ("cow_copies", "paddle_tpu_prefix_cow_copies_total"),
                ("evicted", "paddle_tpu_prefix_evicted_pages_total"),
                ("cached_pages", "paddle_tpu_prefix_cached_pages"),
                ("shared_pages", "paddle_tpu_prefix_shared_pages"),
                ("sampled_requests",
                 "paddle_tpu_sampling_requests_total"),
                ("sampled_tokens",
                 "paddle_tpu_sampling_tokens_total")):
            v = total(name)
            if v:
                prefix[key_] = v
        if prefix:
            out["prefix"] = prefix
        return out

    # -- completion + tail sampling --------------------------------------
    def _p99_threshold(self) -> float | None:
        if len(self._durs) < 32:
            return None
        s = sorted(self._durs)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    def _sweep_locked(self, now: float):
        done = [tid for tid, tb in self._open.items()
                if now - tb.last >= self.linger_s]
        for tid in done:
            self._finalize_locked(tid, self._open.pop(tid))
        # fleet-state GC: age out processes that stopped reporting —
        # a dead agent must not pad the fleet table forever (the
        # absence alert has already had retire_s > its max_age_s to
        # notice the silence first)
        if self.retire_s > 0:
            wall = time.time()
            stale = [k for k, p in self._procs.items()
                     if wall - (p.get("last_seen") or wall)
                     > self.retire_s]
            for k in stale:
                p = self._procs.pop(k)
                self.counts["procs_retired"] += 1
                _RETIRED.inc()
                self._recent_events.append(
                    {"host": k[0], "pid": k[1], "role": p.get("role"),
                     "wall": wall, "kind": "proc_retired",
                     "attrs": {"last_seen": p.get("last_seen")}})

    def sweep(self, force: bool = False) -> int:
        """Finalize quiescent (or, with ``force``, all) open traces;
        returns how many closed. Tests drive this deterministically."""
        with self._lock:
            before = len(self._open)
            now = time.monotonic() + (1e12 if force else 0.0)
            self._sweep_locked(now)
            return before - len(self._open)

    def _finalize_locked(self, tid: str, tb: _TraceBuild):
        tb.spans.sort(key=lambda s: s["t0"])
        t0 = min((s["t0"] for s in tb.spans), default=0.0)
        t1 = max((s["t1"] for s in tb.spans), default=t0)
        dur = t1 - t0
        thresh = self._p99_threshold()
        self._durs.append(dur)
        self.counts["assembled"] += 1
        if tb.error or tb.flagged:
            verdict = "kept_error"
        elif thresh is not None and dur >= thresh:
            verdict = "kept_slow"
        elif self.sample > 0 and (int(tid[:12] or "0", 16) % 1000000
                                  < self.sample * 1000000):
            verdict = "kept_sampled"
        else:
            verdict = "sampled_out"
        self.counts[verdict] += 1
        _TRACES.labels(verdict=verdict).inc()
        if verdict == "sampled_out":
            return
        assembled = {
            "trace_id": tid, "verdict": verdict, "complete": True,
            "start_wall": t0, "duration_ms": dur * 1000.0,
            "error": tb.error, "watchdog_flagged": tb.flagged,
            "procs": sorted({(s["host"], s["pid"], s["role"])
                             for s in tb.spans}),
            "spans": tb.spans, "flight": tb.flight,
        }
        self._kept[tid] = assembled
        self._kept.move_to_end(tid)
        while len(self._kept) > self.ring_max:
            self._kept.popitem(last=False)
            self.counts["evicted"] += 1
            _EVICTED.inc()

    # -- reads -----------------------------------------------------------
    def trace(self, tid: str) -> dict | None:
        """The assembled trace, or a ``complete: False`` partial while
        spans are still arriving, or None if unknown/sampled out."""
        with self._lock:
            self._sweep_locked(time.monotonic())
            got = self._kept.get(tid)
            if got is not None:
                return got
            tb = self._open.get(tid)
            if tb is None:
                return None
            spans = sorted(tb.spans, key=lambda s: s["t0"])
            return {"trace_id": tid, "complete": False,
                    "error": tb.error,
                    "watchdog_flagged": tb.flagged,
                    "procs": sorted({(s["host"], s["pid"], s["role"])
                                     for s in spans}),
                    "spans": spans, "flight": list(tb.flight)}

    def traces(self, limit: int = 64) -> list[dict]:
        with self._lock:
            self._sweep_locked(time.monotonic())
            out = [{"trace_id": t["trace_id"],
                    "verdict": t["verdict"],
                    "duration_ms": t["duration_ms"],
                    "start_wall": t["start_wall"],
                    "spans": len(t["spans"]),
                    "procs": len(t["procs"]),
                    "error": t["error"]}
                   for t in self._kept.values()]
        out.reverse()           # newest first
        return out[:max(1, int(limit))]

    def fleet(self) -> dict:
        with self._lock:
            self._sweep_locked(time.monotonic())
            procs = []
            for (host, pid), p in sorted(self._procs.items()):
                procs.append({
                    "host": host, "pid": pid, "role": p.get("role"),
                    "last_seen": p.get("last_seen"),
                    "age_s": max(0.0, time.time()
                                 - (p.get("last_seen") or 0.0)),
                    "rtt": p.get("rtt"),
                    "offset": p.get("offset"),
                    "dropped": p.get("dropped") or {},
                    "summary": dict(p.get("summary") or {}),
                    "events": list(p["events"])[-8:],
                })
            return {"time": time.time(), "procs": procs,
                    "recent_events": list(self._recent_events),
                    "traces": {k: self.counts[k] for k in
                               ("assembled", "kept_error", "kept_slow",
                                "kept_sampled", "sampled_out",
                                "evicted")},
                    "open_traces": len(self._open),
                    "kept_traces": len(self._kept)}

    def stats(self) -> dict:
        with self._lock:
            out = {"counts": dict(self.counts),
                   "open": len(self._open), "kept": len(self._kept),
                   "procs": len(self._procs),
                   "sample": self.sample, "ring_max": self.ring_max,
                   "linger_s": self.linger_s,
                   "retire_s": self.retire_s,
                   "p99_threshold_s": self._p99_threshold(),
                   "started": self._started}
        if self.tsdb is not None:
            out["tsdb"] = self.tsdb.stats()
        if self.alerts is not None:
            out["alerts"] = dict(self.alerts.counts)
        return out

    # -- TSDB query verb -------------------------------------------------
    def tsdb_query(self, req: dict) -> dict:
        """``tsdb_query`` verb body: one query per request.

        ``{"op": "tsdb_query", "query": "rate", "metric": ...,
           "labels": {...}, "window": 60, "q": 0.99,
           "start": t, "end": t}``

        queries: series | latest | range | delta | rate | quantile.
        """
        if self.tsdb is None:
            return {"error": "tsdb disabled (PADDLE_TPU_TSDB=0)"}
        what = str(req.get("query") or "latest")
        metric = req.get("metric")
        labels = req.get("labels") or None
        try:
            if what == "series":
                return {"series": self.tsdb.series(metric)}
            if metric is None:
                return {"error": "metric required"}
            window = float(req.get("window") or 300.0)
            if what == "latest":
                return {"value": self.tsdb.latest(metric, labels)}
            if what == "range":
                end = req.get("end")
                end = float(end) if end is not None \
                    else self.tsdb._default_at(metric)
                start = req.get("start")
                start = float(start) if start is not None \
                    else end - window
                return {"points": self.tsdb.range(
                    metric, labels, start, end)}
            if what == "delta":
                return {"value": self.tsdb.delta(
                    metric, window, labels)}
            if what == "rate":
                return {"value": self.tsdb.rate(
                    metric, window, labels)}
            if what == "quantile":
                return {"value": self.tsdb.quantile(
                    metric, float(req.get("q") or 0.99), window,
                    labels)}
            return {"error": f"unknown query {what!r}"}
        except Exception as e:          # noqa: BLE001 — wire boundary
            return {"error": f"{type(e).__name__}: {e}"}

    # -- Chrome export ---------------------------------------------------
    def chrome_trace(self, tid: str) -> dict | None:
        """One merged Chrome trace for an assembled trace id: per-rank
        pid labels, timestamps on the collector-aligned wall clock
        (relative to trace start)."""
        t = self.trace(tid)
        if t is None or not t.get("spans"):
            return None
        t0 = min(s["t0"] for s in t["spans"])
        per_rank: dict = OrderedDict()
        for s in t["spans"]:
            key = (s["host"], s["pid"])
            per_rank.setdefault(
                key, (f"{s['role']} {s['host']}:{s['pid']}", []))
            args = {"trace_id": s["trace_id"],
                    "span_id": s.get("span_id")}
            if s.get("parent_id"):
                args["parent_id"] = s["parent_id"]
            args.update(s.get("attrs") or {})
            per_rank[key][1].append({
                "name": s["name"], "ph": "X", "cat": "paddle_tpu",
                "ts": round((s["t0"] - t0) * 1e6, 3),
                "dur": round((s["t1"] - s["t0"]) * 1e6, 3),
                "tid": s.get("tid", 0), "args": args})
        return merge_chrome_traces(per_rank.values())


# ---------------------------------------------------------------------------
# verb switch (shared by the standalone server and PS hosting)
# ---------------------------------------------------------------------------

def telemetry_dispatch(collector: TelemetryCollector, req: dict,
                       keepalive: float = 2.0):
    """The ``tel_*`` verb switch. Returns a reply dict — or, for
    ``tel_watch``, a dispatch generator the RPC layer streams as
    server-push frames (the ``pub_watch`` idiom)."""
    op = req["op"]
    if op == "tel_push":
        return collector.ingest(req)
    if op == "tel_ping":
        return {"ok": True, "t_collector": time.time()}
    if op == "tel_fleet":
        if collector.alerts is not None:
            collector.alerts.maybe_evaluate()
        return {"fleet": collector.fleet()}
    if op == "tsdb_query":
        return collector.tsdb_query(req)
    if op == "alerts":
        if collector.alerts is None:
            return {"alerts": {"active": [], "history": [],
                               "rules": []}}
        collector.alerts.maybe_evaluate()
        return {"alerts": collector.alerts.state()}
    if op == "usage_report":
        return {"usage": _meter.usage_report(
            collector.tsdb, window=req.get("window"))}
    if op == "tel_trace":
        tid = str(req["trace_id"])
        rep = {"trace": collector.trace(tid)}
        if req.get("chrome"):
            rep["chrome"] = collector.chrome_trace(tid)
        return rep
    if op == "tel_traces":
        return {"traces": collector.traces(
            limit=int(req.get("limit", 64)))}
    if op == "tel_stats":
        return collector.stats()
    if op == "tel_watch":
        return _watch_stream(collector, keepalive)
    raise ValueError(f"unknown telemetry op {op!r}")


def _watch_stream(collector: TelemetryCollector, keepalive: float):
    """tel_watch dispatch generator: fleet snapshot ack, then one
    frame per keepalive tick (a live dashboard's feed). Cancellation
    (the client abandoning the stream) is observed at each yield."""
    yield {"subscribed": True, "fleet": collector.fleet()}
    while True:
        time.sleep(max(0.1, keepalive))
        yield {"fleet": collector.fleet()}


# ---------------------------------------------------------------------------
# standalone server (the launcher's --telemetry)
# ---------------------------------------------------------------------------

class CollectorServer:
    """Standalone collector endpoint over the mux wire (the
    RegistryServer shape): serves exactly `telemetry_dispatch` plus
    ping."""

    READ_OPS = frozenset(TEL_READ_OPS | {"ping"})

    def __init__(self, endpoint: str = "127.0.0.1:0",
                 secret: str | None = None,
                 collector: TelemetryCollector | None = None):
        import socketserver

        from ..distributed.fleet.runtime.rpc import (RpcServerState,
                                                     serve_connection)
        self.collector = collector or TelemetryCollector()
        if secret is None:
            secret = os.environ.get("PADDLE_PS_SECRET") or None
        self._rpc = RpcServerState(read_ops=self.READ_OPS,
                                   secret=secret)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                serve_connection(self.request, outer._dispatch,
                                 outer._rpc)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        host, port = endpoint.rsplit(":", 1)
        self._server = Server((host, int(port)), Handler)
        self.endpoint = f"{host}:{self._server.server_address[1]}"
        self._thread: threading.Thread | None = None

    def _dispatch(self, req: dict):
        if req.get("op") == "ping":
            return {"ok": True, "role": "telemetry-collector"}
        return telemetry_dispatch(self.collector, req)

    def start(self) -> "CollectorServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="telemetry-collector")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.collector.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.observability.collector`` — the
    child the launcher's ``--telemetry`` spawns. Prints a READY line (the replica
    fixture convention) and serves until killed."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.observability.collector")
    ap.add_argument("--endpoint", default=os.environ.get(
        "PADDLE_TPU_TELEMETRY_COLLECTOR") or "127.0.0.1:0")
    args = ap.parse_args(argv)
    srv = CollectorServer(endpoint=args.endpoint).start()
    print(json.dumps({"ready": True, "endpoint": srv.endpoint,
                      "pid": os.getpid(),
                      "host": socket.gethostname()}), flush=True)
    try:
        while True:
            time.sleep(1.0)
            srv.collector.sweep()
            if srv.collector.alerts is not None:
                srv.collector.alerts.maybe_evaluate()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
