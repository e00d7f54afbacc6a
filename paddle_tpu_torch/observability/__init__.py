"""paddle_tpu_torch.observability — the telemetry the serving engine
writes: a metrics ``registry``, host-span ``tracing`` (bridged into
``torch.profiler``), the ``flight`` recorder's per-tier event rings,
per-tenant usage ``meter`` and the ``perf`` plane (analytic FLOPs, MFU
against the card's data-sheet peak, sampled step breakdowns), the
``watchdog`` (progress-token stall detection: no progress past a
deadline raises ``paddle_tpu_watchdog_*`` metrics, writes a bundle and
can re-raise SIGTERM) and ``debug`` (atomic, CRC-manifested postmortem
bundle directories under ``PADDLE_TPU_DEBUG_DIR``, written on watchdog
fire, unhandled exception, SIGTERM, and on demand through the serving
frontend's ``debug_dump`` verb).

``set_enabled(False)`` (or ``PADDLE_TPU_TELEMETRY=0``) turns metric
writes, span records and flight events into cheap no-ops.
"""
from __future__ import annotations

import atexit
import os
import socket

from . import debug, flight, meter, perf, registry, tracing, watchdog
from .debug import collect, load_bundle, write_bundle
from .flight import RECORDER
from .meter import METER
from .registry import (REGISTRY, counter, gauge, histogram,
                       prometheus_text, to_dict)
from .tracing import TRACER, current_trace_id, new_trace_id, span
from .watchdog import WATCHDOG

__all__ = ["registry", "tracing", "flight", "meter", "perf", "watchdog",
           "debug", "REGISTRY", "TRACER", "RECORDER", "METER",
           "WATCHDOG", "counter", "gauge", "histogram",
           "prometheus_text", "to_dict", "span", "current_trace_id",
           "new_trace_id", "collect", "write_bundle", "load_bundle",
           "set_enabled", "enabled"]


def set_enabled(on: bool):
    """Master switch: metric writes, span recording AND flight events
    (trace ids still propagate)."""
    REGISTRY.set_enabled(on)
    TRACER.enabled = bool(on)
    RECORDER.set_enabled(on)


def enabled() -> bool:
    return REGISTRY.enabled


def _postmortem_dump(reason: str):
    """Evidence dump for process-death paths. Into the metrics dir:
    the registry JSON plus the trace ring and flight rings (each a
    per-process file the offline aggregator can sit next to). Into the
    debug dir: one full CRC-manifested bundle."""
    d = os.environ.get("PADDLE_TPU_METRICS_DIR")
    if d:
        tag = f"{socket.gethostname()}_{os.getpid()}"
        try:
            REGISTRY.dump_to_file()
        except Exception:
            pass
        try:
            TRACER.export_chrome_trace(
                os.path.join(d, f"trace_{tag}.json"))
        except Exception:
            pass
        try:
            RECORDER.dump_to_file(
                os.path.join(d, f"flight_{tag}.json"))
        except Exception:
            pass
    debug.try_write_bundle(reason)


if os.environ.get("PADDLE_TPU_METRICS_DIR"):
    # per-process dump at exit: each process of a job leaves one
    # metrics_<host>_<pid>.json for debug.aggregate_with_bundles
    @atexit.register
    def _dump_metrics_at_exit():
        try:
            REGISTRY.dump_to_file()
        except Exception:
            pass


if os.environ.get("PADDLE_TPU_METRICS_DIR") \
        or os.environ.get("PADDLE_TPU_DEBUG_DIR"):
    # SIGTERM does NOT run atexit hooks, and that is exactly how
    # a supervisor stops a process (and any survivors after a failure or
    # a hung-rank teardown): dump the metrics + trace ring + flight
    # rings (+ a debug bundle when PADDLE_TPU_DEBUG_DIR is set), then
    # die with the default disposition so the exit code stays 143.
    # Installed only over the DEFAULT handler — an app with its own
    # SIGTERM logic keeps it (and can call _postmortem_dump itself).
    def _install_sigterm_dump():
        import signal
        import threading
        if threading.current_thread() is not threading.main_thread():
            return
        if signal.getsignal(signal.SIGTERM) != signal.SIG_DFL:
            return

        def _on_term(signum, frame):
            # the handler interrupts an arbitrary main-thread frame,
            # which may HOLD one of the non-reentrant locks the dump
            # needs (flight ring, a registry child, a scheduler lock
            # behind a requests provider). A deadlocked dump must cost
            # a bounded wait, not the exit: arm a hard-exit escalation
            # FIRST, so the process still dies 143 with whatever
            # evidence made it to disk.
            debug.arm_hard_exit(name="sigterm-dump-escalate")
            _postmortem_dump("sigterm")
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)

    try:
        _install_sigterm_dump()
    except Exception:
        pass


if os.environ.get("PADDLE_TPU_DEBUG_DIR"):
    # unhandled exceptions (main thread or any worker thread) leave a
    # bundle behind before the traceback prints
    try:
        debug.install_crash_hooks()
    except Exception:
        pass


if os.environ.get("PADDLE_TPU_WATCHDOG", "") not in ("", "0"):
    # opt-in background stall polling; tiers register their progress
    # tokens unconditionally (registration is free), the thread only
    # runs when a job asks for it
    try:
        WATCHDOG.start()
    except Exception:
        pass
