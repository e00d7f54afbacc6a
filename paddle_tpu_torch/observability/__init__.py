"""paddle_tpu_torch.observability — the telemetry the serving engine
writes: a metrics ``registry``, host-span ``tracing`` (bridged into
``torch.profiler``), the ``flight`` recorder's per-tier event rings,
per-tenant usage ``meter`` and the ``perf`` plane (analytic FLOPs, MFU
against the card's data-sheet peak, sampled step breakdowns).

``set_enabled(False)`` (or ``PADDLE_TPU_TELEMETRY=0``) turns metric
writes, span records and flight events into cheap no-ops.
"""
from __future__ import annotations

from . import flight, meter, perf, registry, tracing
from .flight import RECORDER
from .meter import METER
from .registry import (REGISTRY, counter, gauge, histogram,
                       prometheus_text, to_dict)
from .tracing import TRACER, current_trace_id, new_trace_id, span

__all__ = ["registry", "tracing", "flight", "meter", "perf", "REGISTRY",
           "TRACER", "RECORDER", "METER", "counter", "gauge", "histogram",
           "prometheus_text", "to_dict", "span", "current_trace_id",
           "new_trace_id", "set_enabled", "enabled"]


def set_enabled(on: bool):
    """Master switch: metric writes, span recording AND flight events
    (trace ids still propagate)."""
    REGISTRY.set_enabled(on)
    TRACER.enabled = bool(on)
    RECORDER.set_enabled(on)


def enabled() -> bool:
    return REGISTRY.enabled
