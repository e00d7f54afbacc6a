"""Structured host-side tracing: spans with trace/span ids.

The cross-tier half of the telemetry substrate (registry.py holds the
numbers; this holds the *timeline*):

  * ``span(name, **attrs)`` — context manager recording a host span
    into a bounded ring buffer; spans nest via a thread-local stack and
    children inherit their parent's ``trace_id``;
  * trace propagation — ``current_trace_id()`` reads the ambient id
    (the engine stamps it on each request), and
    ``span(..., trace_id=...)`` re-roots the context, so one request's
    spans and flight events share an id;
  * Chrome export — ``export_chrome_trace()`` emits ``trace_event``
    JSON (Perfetto / chrome://tracing), one complete event per span
    with trace/span ids in ``args``;
  * profiler bridge — every recorded span also enters
    ``torch.profiler.record_function``, so host spans line up with the
    CUDA kernels inside a ``torch.profiler.profile`` window (a no-op
    cost of one context manager when no profiler is active).

``PADDLE_TPU_TRACE=0`` disables recording (ids still propagate so
downstream tiers keep correlating); ``PADDLE_TPU_TRACE_BRIDGE=0``
disables only the profiler bridge.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import deque

from . import registry as _obs

__all__ = ["Span", "Tracer", "TRACER", "span", "current_trace_id",
           "export_chrome_trace", "new_trace_id"]

# the span ring is bounded; overwrites used to be silent — mirror the
# flight rings' drop accounting so a reader knows the window clipped
_DROPPED = _obs.counter(
    "paddle_tpu_trace_dropped_total",
    "spans overwritten by a full trace ring")
_HIGH_WATER = _obs.gauge(
    "paddle_tpu_trace_ring_high_water",
    "max spans ever resident in the trace ring (ring size when the "
    "ring has wrapped)")


def new_trace_id() -> str:
    return os.urandom(8).hex()


def _record_function():
    """torch.profiler.record_function, or None while the process has not
    imported torch: then no profiler can be recording, and a span (an
    RPC call on a wire-only client, say) must not pay the seconds of a
    first torch import."""
    if "torch" not in sys.modules:
        return None
    from torch.profiler import record_function
    return record_function


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "tid", "attrs")

    def __init__(self, name, trace_id, span_id, parent_id, start,
                 tid, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end = None
        self.tid = tid
        self.attrs = attrs

    def duration(self) -> float | None:
        return None if self.end is None else self.end - self.start

    def to_event(self) -> dict:
        """One Chrome trace_event 'X' (complete) event."""
        args = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            args["parent_id"] = self.parent_id
        args.update(self.attrs)
        return {"name": self.name, "ph": "X", "cat": "paddle_tpu",
                "ts": round(self.start * 1e6, 3),
                "dur": round(((self.end or self.start) - self.start)
                             * 1e6, 3),
                "pid": os.getpid(), "tid": self.tid, "args": args}


class Tracer:
    """Bounded span recorder + thread-local trace context."""

    def __init__(self, max_spans: int = 16384, enabled: bool | None
                 = None, bridge_profiler: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("PADDLE_TPU_TRACE", "1") != "0"
        if bridge_profiler is None:
            bridge_profiler = os.environ.get(
                "PADDLE_TPU_TRACE_BRIDGE", "1") != "0"
        self.enabled = bool(enabled)
        self.bridge_profiler = bool(bridge_profiler)
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._high_water = 0

    # -- context --------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_trace_id(self) -> str | None:
        st = self._stack()
        return st[-1].trace_id if st else None

    def current_span(self) -> Span | None:
        st = self._stack()
        return st[-1] if st else None

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str | None = None, **attrs):
        """Record one host span. ``trace_id`` re-roots the context (a
        request id that arrived over the wire); otherwise the ambient
        parent's id is inherited, else a fresh one is minted."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        tid = trace_id or (parent.trace_id if parent else None) \
            or new_trace_id()
        sp = Span(name, tid, new_trace_id(),
                  parent.span_id if parent and parent.trace_id == tid
                  else None,
                  time.monotonic(), threading.get_ident(), attrs)
        stack.append(sp)
        ann = None
        if self.enabled and self.bridge_profiler:
            rf = _record_function()
            if rf is not None:
                ann = rf(name)
                ann.__enter__()
        try:
            yield sp
        finally:
            sp.end = time.monotonic()
            if ann is not None:
                ann.__exit__(None, None, None)
            stack.pop()
            if self.enabled:
                with self._lock:
                    if len(self._spans) == self._spans.maxlen:
                        _DROPPED.inc()
                    self._spans.append(sp)
                    n = len(self._spans)
                    if n > self._high_water:
                        self._high_water = n
                        _HIGH_WATER.set(n)

    # -- inspection / export --------------------------------------------
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()

    def export_chrome_trace(self, path: str | None = None) -> dict:
        """{"traceEvents": [...]} — load in Perfetto/chrome://tracing.
        Open it next to a torch.profiler trace of the same window: the
        bridge gives the profiler's host ranges the same span names."""
        doc = {"traceEvents": [s.to_event() for s in self.spans()],
               "displayTimeUnit": "ms"}
        if path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        return doc


TRACER = Tracer()
span = TRACER.span
current_trace_id = TRACER.current_trace_id
export_chrome_trace = TRACER.export_chrome_trace
