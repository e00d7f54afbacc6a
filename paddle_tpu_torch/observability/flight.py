"""Flight recorder: bounded per-tier rings of structured events.

The registry holds the *numbers* and the tracer holds *timed spans*;
this module holds the **black box** — the last N discrete things each
tier did (request admitted, decode step ran, bucket first called),
cheap enough to leave on in production.

Design rules:

  * one bounded ``deque`` ring PER TIER (``serving``, ``perf``, ...) so
    a chatty tier (decode steps) can never evict another tier's sparse
    events;
  * every event carries a monotonic timestamp, a wall-clock stamp, an
    optional ``trace_id`` and free-form attrs — ``timeline(tid)``
    reassembles one request's story across tiers;
  * recording is thread-safe (one recorder lock; events are built
    outside it) and NEAR-ZERO when disabled: ``record()`` is one
    attribute check and a return (``PADDLE_TPU_FLIGHT=0`` or
    ``RECORDER.set_enabled(False)``);
  * ``snapshot()`` is JSON-safe by construction (attrs are sanitized at
    export time, not on the hot path).

Ring size: ``PADDLE_TPU_FLIGHT_RING`` (default 2048 events per tier);
overwrites are counted in ``paddle_tpu_flight_dropped_total`` so a
reader knows the window was clipped.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

import numpy as np

from . import registry as _obs

__all__ = ["FlightEvent", "FlightRecorder", "RECORDER", "record",
           "events", "snapshot", "timeline", "clear", "dump_to_file",
           "DEFAULT_RING_EVENTS"]

DEFAULT_RING_EVENTS = 2048

_EVENTS = _obs.counter(
    "paddle_tpu_flight_events_total",
    "flight-recorder events recorded, by tier ring", ["tier"])
_DROPPED = _obs.counter(
    "paddle_tpu_flight_dropped_total",
    "flight-recorder events overwritten by a full ring, by tier",
    ["tier"])


def _safe(v):
    """JSON-safe attr value (applied at snapshot/export time only —
    the record hot path stores attrs raw)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist() if v.size <= 64 \
            else f"<ndarray shape={v.shape} dtype={v.dtype}>"
    if isinstance(v, (list, tuple)):
        return [_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _safe(x) for k, x in v.items()}
    return str(v)


class FlightEvent:
    __slots__ = ("ts", "wall", "tier", "kind", "trace_id", "attrs")

    def __init__(self, ts, wall, tier, kind, trace_id, attrs):
        self.ts = ts              # time.monotonic() — orders events
        self.wall = wall          # time.time() — for humans/merging
        self.tier = tier
        self.kind = kind
        self.trace_id = trace_id
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {"ts": self.ts, "wall": self.wall, "tier": self.tier,
             "kind": self.kind}
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.attrs:
            d["attrs"] = {k: _safe(v) for k, v in self.attrs.items()}
        return d


class FlightRecorder:
    """Bounded per-tier event rings; see module docstring."""

    def __init__(self, max_events: int | None = None,
                 enabled: bool | None = None):
        if max_events is None:
            max_events = int(os.environ.get(
                "PADDLE_TPU_FLIGHT_RING", str(DEFAULT_RING_EVENTS))
                or DEFAULT_RING_EVENTS)
        if enabled is None:
            enabled = os.environ.get("PADDLE_TPU_FLIGHT", "1") != "0"
        self.max_events = max(1, int(max_events))
        self.enabled = bool(enabled)
        self._rings: dict[str, deque[FlightEvent]] = {}
        self._lock = threading.Lock()
        # optional per-event tap (the telemetry agent): called OUTSIDE
        # the recorder lock with each event; must never block
        self._sink = None

    def set_enabled(self, on: bool):
        self.enabled = bool(on)

    def set_sink(self, fn):
        """``fn(event)`` runs for every recorded event (after ring
        append, outside the recorder lock). Pass None to detach. The
        sink must be cheap and non-blocking — it runs on the recording
        thread."""
        self._sink = fn

    # -- hot path -------------------------------------------------------
    def record(self, tier: str, kind: str, /,
               trace_id: str | None = None,
               **attrs) -> FlightEvent | None:
        # tier/kind are positional-ONLY so attrs may freely reuse those
        # names (e.g. a snapshot event's kind="base"|"delta" attr)
        if not self.enabled:
            return None
        ev = FlightEvent(time.monotonic(), time.time(), tier, kind,
                         trace_id, attrs)
        with self._lock:
            ring = self._rings.get(tier)
            if ring is None:
                ring = self._rings[tier] = deque(maxlen=self.max_events)
            if len(ring) == ring.maxlen:
                _DROPPED.labels(tier=tier).inc()
            ring.append(ev)
        _EVENTS.labels(tier=tier).inc()
        sink = self._sink
        if sink is not None:
            try:
                sink(ev)
            except Exception:
                pass
        return ev

    # -- inspection / export --------------------------------------------
    def events(self, tier: str | None = None) -> list[FlightEvent]:
        with self._lock:
            if tier is not None:
                return list(self._rings.get(tier, ()))
            out = [ev for ring in self._rings.values() for ev in ring]
        out.sort(key=lambda e: e.ts)
        return out

    def timeline(self, trace_id: str) -> list[FlightEvent]:
        """Every recorded event carrying `trace_id`, across all tiers,
        in monotonic order — one request's story."""
        return [ev for ev in self.events() if ev.trace_id == trace_id]

    def snapshot(self) -> dict:
        """JSON-safe dump of every ring."""
        with self._lock:
            tiers = {t: [ev.to_dict() for ev in ring]
                     for t, ring in self._rings.items()}
        return {"enabled": self.enabled, "max_events": self.max_events,
                "monotonic": time.monotonic(), "time": time.time(),
                "tiers": tiers}

    def clear(self):
        with self._lock:
            self._rings.clear()

    def dump_to_file(self, path: str) -> str:
        """Atomic JSON dump (tmp + rename, like the registry dump)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.snapshot(), f)
        os.replace(tmp, path)
        return path

# process-wide recorder + module-level shortcuts
RECORDER = FlightRecorder()
record = RECORDER.record
events = RECORDER.events
snapshot = RECORDER.snapshot
timeline = RECORDER.timeline
clear = RECORDER.clear
dump_to_file = RECORDER.dump_to_file
