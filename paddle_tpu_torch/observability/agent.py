"""Telemetry agent: per-process streamer to the fleet collector
(counterpart of ``paddle_tpu/observability/agent.py``; its ``tel_push``
batches are the JAX package's, so either package's agent streams to
the other's collector).

One ``TelemetryAgent`` per process taps the local telemetry substrate
(finished spans via ``Tracer.set_sink``, flight events via
``FlightRecorder.set_sink``, discrete events like watchdog stalls via
``publish_event``) into a **bounded drop-oldest queue**, and a single
daemon sender thread batches the queue over the mux RPC wire to a
``TelemetryCollector`` (``observability.collector``) as ``tel_push``
calls. Periodic clock-sync pings (``tel_ping`` RTT midpoints, smallest
RTT wins) ride along so the collector can align this process's
monotonic span clocks onto its own wall clock.

Hard rules, in priority order:

  * **serving is never blocked by telemetry** — the sinks are one
    deque append under a tiny agent lock; ALL socket IO lives on the
    sender thread, which holds no lock any serving path takes;
  * **overload drops oldest, visibly** — the queue is bounded
    (``PADDLE_TPU_TELEMETRY_QUEUE``); overwrites increment
    ``paddle_tpu_telemetry_agent_dropped_total{kind}`` exactly like
    the flight rings' drop accounting;
  * **a dead collector costs one failed send per flush** — sends are
    single-attempt with a short timeout; failures drop the batch
    (counted), back off, and the next flush reconnects (the
    ``pub_watch`` re-subscribe idiom).

Arming: ``PADDLE_TPU_TELEMETRY_COLLECTOR=host:port`` auto-starts the
process agent at ``paddle_tpu_torch.observability`` import (the watchdog
autostart pattern), or call ``arm(endpoint)`` explicitly.
"""
from __future__ import annotations

import os
import socket
import sys
import threading
import time
from collections import deque

from . import flight as _flight
from . import registry as _obs
from . import tracing as _tracing

__all__ = ["TelemetryAgent", "arm", "disarm", "get_agent",
           "publish_event", "maybe_start_from_env"]

_DROPPED = _obs.counter(
    "paddle_tpu_telemetry_agent_dropped_total",
    "telemetry items dropped by the agent (full queue, or a failed "
    "send discarding its batch), by item kind", ["kind"])
_BATCHES = _obs.counter(
    "paddle_tpu_telemetry_agent_batches_total",
    "tel_push batches successfully delivered to the collector")
_SEND_ERRORS = _obs.counter(
    "paddle_tpu_telemetry_agent_send_errors_total",
    "tel_push/tel_ping attempts that failed (collector down or slow)")

# same redaction contract as debug bundles: credential-looking attr
# keys never leave the process
_SECRET_MARKERS = ("SECRET", "TOKEN", "PASSWORD", "CREDENTIAL")


def _redact_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        ku = str(k).upper()
        if any(m in ku for m in _SECRET_MARKERS) or ku.endswith("_KEY"):
            out[str(k)] = "<redacted>"
        else:
            out[str(k)] = _flight._safe(v)
    return out


def _span_dict(sp) -> dict:
    d = {"name": sp.name, "trace_id": sp.trace_id,
         "span_id": sp.span_id, "parent_id": sp.parent_id,
         "start": sp.start, "end": sp.end, "tid": sp.tid}
    if sp.attrs:
        d["attrs"] = _redact_attrs(sp.attrs)
    return d


class TelemetryAgent:
    """See module docstring. One instance per process (via ``arm``);
    standalone instances are fine for tests."""

    def __init__(self, endpoint: str, role: str | None = None,
                 queue_max: int | None = None,
                 flush_s: float | None = None,
                 secret: str | None = None,
                 metrics_every: int = 4):
        if queue_max is None:
            queue_max = int(os.environ.get(
                "PADDLE_TPU_TELEMETRY_QUEUE", "4096") or 4096)
        if flush_s is None:
            flush_s = float(os.environ.get(
                "PADDLE_TPU_TELEMETRY_FLUSH", "0.5") or 0.5)
        self.endpoint = endpoint
        if role is None:
            role = os.environ.get("PADDLE_TPU_TELEMETRY_ROLE")
        if not role:
            role = os.path.basename((sys.argv[0] if sys.argv else "")
                                    or "")
            # under `python -m pkg` the agent can arm (via package
            # import) while runpy still has the "-m" placeholder in
            # argv[0] — never report that as a fleet role
            if not role or role in ("-m", "-c", "-"):
                role = "proc"
        self.role = role
        self.flush_s = max(0.05, float(flush_s))
        self._secret = secret if secret is not None \
            else os.environ.get("PADDLE_PS_SECRET") or None
        self._q: deque = deque(maxlen=max(1, int(queue_max)))
        self._qlock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cli = None
        # wall = monotonic + anchor (this process); collector wall =
        # wall + offset (clock sync). Reported with every push.
        self._anchor = time.time() - time.monotonic()
        self._offset = 0.0
        self._best_rtt: float | None = None
        self._metrics_every = max(1, int(metrics_every))
        self._flushes = 0
        self.batches_sent = 0
        self.send_errors = 0
        self.dropped: dict[str, int] = {}
        self._host = socket.gethostname()
        self._pid = os.getpid()
        self._rpc_client_cls = None

    # -- producers (serving threads; must never block) -----------------
    def _enqueue(self, kind: str, item):
        with self._qlock:
            if len(self._q) == self._q.maxlen:
                old_kind = self._q[0][0]
                self.dropped[old_kind] = self.dropped.get(old_kind, 0) + 1
                _DROPPED.labels(kind=old_kind).inc()
            self._q.append((kind, item))

    def _on_span(self, sp):
        # never stream the agent's own transport spans (rpc.client
        # tel_push/tel_ping, or a hosted collector's rpc.server.tel_*):
        # each flush would mint fresh trace ids for the next flush to
        # ship — telemetry-of-telemetry feedback junk in the collector
        if str((sp.attrs or {}).get("op", "")).startswith("tel_") \
                or sp.name.startswith("rpc.server.tel_"):
            return
        self._enqueue("span", sp)

    def _on_flight(self, ev):
        self._enqueue("flight", ev)

    def publish_event(self, kind: str, **attrs):
        """Discrete fleet event (watchdog stall, bundle written, ...)
        — shows up under the collector's recent-events feed."""
        self._enqueue("event", {"kind": kind, "wall": time.time(),
                                "attrs": _redact_attrs(attrs)})

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "TelemetryAgent":
        if self._thread is not None:
            return self
        # resolve the transport import on the CALLER's thread: a lazy
        # import on the sender thread deadlocks against an in-progress
        # interpreter import of the package tree (env-armed agents
        # start during `paddle_tpu_torch.observability` import)
        from ..distributed.fleet.runtime.rpc import RpcClient
        self._rpc_client_cls = RpcClient
        _tracing.TRACER.set_sink(self._on_span)
        _flight.RECORDER.set_sink(self._on_flight)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="telemetry-agent")
        self._thread.start()
        return self

    def stop(self, flush: bool = True):
        if _tracing.TRACER._sink is self._on_span:
            _tracing.TRACER.set_sink(None)
        if _flight.RECORDER._sink is self._on_flight:
            _flight.RECORDER.set_sink(None)
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0 if flush else 0.5)
            self._thread = None
        cli, self._cli = self._cli, None
        if cli is not None:
            try:
                cli.close()
            except Exception:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- sender thread (the ONLY place sockets are touched) ------------
    def _client(self):
        if self._cli is None:
            cls = self._rpc_client_cls
            if cls is None:       # unstarted agent driven by tests
                from ..distributed.fleet.runtime.rpc import RpcClient \
                    as cls
            self._cli = cls(self.endpoint, secret=self._secret,
                            timeout=2.0, deadline=2.0, max_retries=0)
        return self._cli

    def _drop_conn(self):
        cli, self._cli = self._cli, None
        if cli is not None:
            try:
                cli.close()
            except Exception:
                pass

    def _sync_clock(self):
        t0 = time.time()
        rep = self._client().call({"op": "tel_ping"}, timeout=2.0,
                                  deadline=2.0, max_retries=0)
        t1 = time.time()
        rtt = t1 - t0
        # smallest-RTT exchange wins: its midpoint bounds the skew
        # tightest (allow mild regression so the estimate can track)
        if self._best_rtt is None or rtt <= self._best_rtt * 1.5:
            if self._best_rtt is None or rtt < self._best_rtt:
                self._best_rtt = rtt
            self._offset = float(rep["t_collector"]) - (t0 + t1) / 2.0

    def _drain(self):
        with self._qlock:
            items, self._q = list(self._q), deque(maxlen=self._q.maxlen)
        return items

    def _build_batch(self, items) -> dict:
        spans, flights, events = [], [], []
        for kind, item in items:
            if kind == "span":
                spans.append(_span_dict(item))
            elif kind == "flight":
                flights.append(item.to_dict())
            else:
                events.append(item)
        batch = {"op": "tel_push", "host": self._host, "pid": self._pid,
                 "role": self.role, "anchor": self._anchor,
                 "offset": self._offset, "rtt": self._best_rtt,
                 "wall": time.time(), "spans": spans,
                 "flight": flights, "events": events,
                 "dropped": dict(self.dropped)}
        self._flushes += 1
        if self._flushes % self._metrics_every == 1:
            batch["metrics"] = _obs.to_dict()
        return batch

    def flush_once(self) -> bool:
        """One drain+send cycle (the sender loop body; tests call it
        directly for determinism). Returns True when the batch was
        delivered."""
        items = self._drain()
        batch = self._build_batch(items)
        try:
            if self._best_rtt is None or self._flushes % 8 == 1:
                self._sync_clock()
                batch["offset"] = self._offset
                batch["rtt"] = self._best_rtt
            self._client().call(batch, timeout=2.0, deadline=2.0,
                                max_retries=0)
        except Exception:
            self.send_errors += 1
            _SEND_ERRORS.inc()
            self._drop_conn()
            n = len(items)
            if n:
                self.dropped["send"] = self.dropped.get("send", 0) + n
                _DROPPED.labels(kind="send").inc(n)
            return False
        self.batches_sent += 1
        _BATCHES.inc()
        return True

    def _run(self):
        backoff = self.flush_s
        while not self._stop.wait(backoff):
            ok = self.flush_once()
            # failed sends back off (capped) so a dead collector costs
            # one cheap connect attempt every few seconds, not a storm
            backoff = self.flush_s if ok \
                else min(5.0, max(backoff, self.flush_s) * 2)
        # final best-effort flush so short-lived processes (launcher
        # children exiting) deliver their tail
        try:
            self.flush_once()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# process-wide agent
# ---------------------------------------------------------------------------

_AGENT: TelemetryAgent | None = None
_ARM_LOCK = threading.Lock()


def get_agent() -> TelemetryAgent | None:
    return _AGENT


def arm(endpoint: str, **kw) -> TelemetryAgent:
    """Start (or replace) the process agent streaming to
    ``endpoint``."""
    global _AGENT
    with _ARM_LOCK:
        if _AGENT is not None:
            _AGENT.stop(flush=False)
        _AGENT = TelemetryAgent(endpoint, **kw).start()
        return _AGENT


def disarm():
    global _AGENT
    with _ARM_LOCK:
        if _AGENT is not None:
            _AGENT.stop()
            _AGENT = None


def publish_event(kind: str, **attrs):
    """Fire-and-forget fleet event; silent no-op when no agent is
    armed (the watchdog/debug call sites are unconditional)."""
    a = _AGENT
    if a is not None:
        try:
            a.publish_event(kind, **attrs)
        except Exception:
            pass


def maybe_start_from_env():
    """Arm from ``PADDLE_TPU_TELEMETRY_COLLECTOR`` when set (called
    once at ``paddle_tpu_torch.observability`` import)."""
    ep = os.environ.get("PADDLE_TPU_TELEMETRY_COLLECTOR", "").strip()
    if ep and _AGENT is None:
        try:
            arm(ep)
        except Exception:
            pass
