"""Metrics registry: labeled counters, gauges, fixed-bucket histograms.

One process-wide registry (``REGISTRY``) is the telemetry substrate the
serving engine, scheduler, page pool and perf plane write into, as
Prometheus-style series so one scrape shows every tier. Design rules:

  * thread-safe — every child series carries its own lock; an increment
    can never be lost to a concurrent reader or writer (tests hammer one
    counter from 8 threads);
  * names are ``paddle_tpu_``-prefixed snake_case, enforced at
    registration (the same names as the JAX package's series);
  * registration is idempotent per (name, kind, labelnames) — the same
    module-level ``counter(...)`` call may run once per process, but a
    name re-registered with a different kind/labelset raises;
  * exposition: Prometheus text (``prometheus_text``) and JSON
    (``to_dict``).

Disabling (``REGISTRY.set_enabled(False)`` or
``PADDLE_TPU_TELEMETRY=0``) turns every write into a cheap early return.

No torch/framework imports here: the registry must be importable from
every module without cycles.
"""
from __future__ import annotations

import json
import math
import os
import re
import socket
import threading
import time

__all__ = [
    "MetricError", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTRY", "counter", "gauge", "histogram", "prometheus_text",
    "to_dict", "dump_to_file", "aggregate_dumps", "DEFAULT_BUCKETS",
]

_NAME_RE = re.compile(r"^paddle_tpu_[a-z][a-z0-9_]*$")
_LABEL_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# latency-flavored default buckets (seconds): sub-ms host work up to
# multi-second compiles
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class MetricError(ValueError):
    """Bad metric name/labels or a conflicting re-registration."""


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _label_str(labelnames, labelvalues) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Child:
    """One labeled series. Holds its own lock so concurrent increments
    from handler/scheduler threads never lose updates."""

    __slots__ = ("_metric", "_values", "_lock")

    def __init__(self, metric, labelvalues):
        self._metric = metric
        self._values = labelvalues
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("_v",)

    def __init__(self, metric, labelvalues):
        super().__init__(metric, labelvalues)
        self._v = 0.0

    def inc(self, n: float = 1.0):
        if not (self._metric.always
                or self._metric._registry._enabled):
            return
        if n < 0:
            raise MetricError("counters only go up")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class _GaugeChild(_Child):
    __slots__ = ("_v", "_fn")

    def __init__(self, metric, labelvalues):
        super().__init__(metric, labelvalues)
        self._v = 0.0
        self._fn = None

    def set(self, v: float):
        if not (self._metric.always
                or self._metric._registry._enabled):
            return
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0):
        if not (self._metric.always
                or self._metric._registry._enabled):
            return
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0):
        self.inc(-n)

    def set_function(self, fn):
        """Evaluate ``fn()`` at exposition time (live queue depth /
        occupancy without a write on every transition)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            v = self._v
        if fn is None:
            return v
        # evaluate OUTSIDE the series lock: set_function callbacks
        # take subsystem locks (scheduler queue depth, pool occupancy)
        # whose holders write metrics — running them under this lock
        # closes a lock-order cycle (analysis lock-callback rule), and
        # a callback touching its own series would self-deadlock
        try:
            return float(fn())
        except Exception:
            return float("nan")


class _HistogramChild(_Child):
    __slots__ = ("_counts", "_sum", "_count", "_exemplars")

    def __init__(self, metric, labelvalues):
        super().__init__(metric, labelvalues)
        self._counts = [0] * (len(metric.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        # bucket index -> {"trace_id", "value"}: the newest observation
        # in that bucket that carried a trace id (OpenMetrics-style
        # exemplars — an slo_report p99 links straight to an assembled
        # trace in the telemetry collector)
        self._exemplars: dict[int, dict] = {}

    def observe(self, v: float, trace_id: str | None = None):
        if not (self._metric.always
                or self._metric._registry._enabled):
            return
        v = float(v)
        buckets = self._metric.buckets
        i = 0
        for i, b in enumerate(buckets):  # noqa: B007
            if v <= b:
                break
        else:
            i = len(buckets)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if trace_id:
                self._exemplars[i] = {"trace_id": str(trace_id),
                                      "value": v}

    def exemplars(self) -> dict[int, dict]:
        """{bucket index: {"trace_id", "value"}} — newest exemplar per
        bucket (index len(buckets) is +Inf)."""
        with self._lock:
            return {i: dict(e) for i, e in self._exemplars.items()}

    def snapshot(self):
        """(cumulative bucket counts incl +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, acc = [], 0
        for n in counts:
            acc += n
            cum.append(acc)
        return cum, s, c

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class _Metric:
    kind = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, help_: str, labelnames, registry,
                 always: bool = False):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        # always=True: writes ignore the registry kill switch. For
        # series that BACK a functional surface (Engine/Scheduler/
        # PagePool.stats read their counts from here) — disabling
        # telemetry must not freeze behavior callers relied on before
        # the registry rebase.
        self.always = bool(always)
        self._registry = registry
        self._children: dict[tuple, _Child] = {}
        # RLock: remove_matching() runs from gc-driven finalizers (a
        # dead Router/RpcClient dropping its per-instance series) and
        # gc can trigger inside labels()/_series() while THIS thread
        # already holds the lock — a plain Lock self-deadlocks there
        self._lock = threading.RLock()
        for ln in self.labelnames:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"bad label name {ln!r}")
        if not self.labelnames:
            self._default = self._make_child(())
        else:
            self._default = None

    def _make_child(self, values):
        child = self._child_cls(self, values)
        self._children[values] = child
        return child

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        values = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(values)
            return child

    def _series(self):
        with self._lock:
            return list(self._children.items())

    def remove_matching(self, **kv):
        """Drop every child whose labels match the given subset (an
        engine/pool tearing down its per-instance series so a
        long-lived process's exposition does not grow with every
        instance ever created). Unknown label keys match nothing."""
        idx = {ln: i for i, ln in enumerate(self.labelnames)}
        if not all(k in idx for k in kv):
            return 0
        with self._lock:
            doomed = [vals for vals in self._children
                      if all(vals[idx[k]] == str(v)
                             for k, v in kv.items())]
            for vals in doomed:
                del self._children[vals]
            return len(doomed)

    # no-label convenience: metric itself acts as its default child
    def __getattr__(self, item):
        if item in ("inc", "dec", "set", "observe", "set_function",
                    "value", "count", "sum", "snapshot", "exemplars"):
            default = self.__dict__.get("_default")
            if default is None:
                raise MetricError(
                    f"{self.name} has labels {self.labelnames}; call "
                    f".labels(...) first")
            return getattr(default, item)
        raise AttributeError(item)


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild


class Histogram(_Metric):
    kind = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help_, labelnames, registry,
                 buckets=DEFAULT_BUCKETS, always: bool = False):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise MetricError("histogram needs at least one bucket")
        super().__init__(name, help_, labelnames, registry,
                         always=always)


class MetricsRegistry:
    """Process-wide metric store; see module docstring."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("PADDLE_TPU_TELEMETRY", "1") != "0"
        self._enabled = bool(enabled)
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    # -- enable/disable -------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool):
        self._enabled = bool(on)

    # -- registration ---------------------------------------------------
    def _register(self, cls, name, help_, labels, **kw):
        if not _NAME_RE.match(name):
            raise MetricError(
                f"metric name {name!r} must match {_NAME_RE.pattern} "
                f"(snake_case with a paddle_tpu_ prefix)")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if (type(m) is not cls
                        or m.labelnames != tuple(labels)
                        or (cls is Histogram and m.buckets != tuple(
                            sorted(float(b) for b in kw.get(
                                "buckets", DEFAULT_BUCKETS))))):
                    raise MetricError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames} — conflicting "
                        f"re-registration")
                return m
            m = cls(name, help_, labels, self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "", labels=(),
                always: bool = False) -> Counter:
        return self._register(Counter, name, help_, labels,
                              always=always)

    def gauge(self, name: str, help_: str = "", labels=(),
              always: bool = False) -> Gauge:
        return self._register(Gauge, name, help_, labels,
                              always=always)

    def histogram(self, name: str, help_: str = "", labels=(),
                  buckets=DEFAULT_BUCKETS,
                  always: bool = False) -> Histogram:
        return self._register(Histogram, name, help_, labels,
                              buckets=buckets, always=always)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- exposition -----------------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text format 0.0.4 over every registered series."""
        out: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            for values, child in sorted(m._series()):
                ls = _label_str(m.labelnames, values)
                if m.kind == "histogram":
                    cum, s, c = child.snapshot()
                    edges = list(m.buckets) + [float("inf")]
                    for b, n in zip(edges, cum):
                        inner = ",".join(filter(None, [
                            ls[1:-1] if ls else "",
                            f'le="{_fmt(b)}"']))
                        out.append(
                            f"{name}_bucket{{{inner}}} {n}")
                    out.append(f"{name}_sum{ls} {_fmt(s)}")
                    out.append(f"{name}_count{ls} {c}")
                else:
                    out.append(f"{name}{ls} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def to_dict(self) -> dict:
        """JSON-safe snapshot."""
        metrics = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            rec = {"name": name, "kind": m.kind, "help": m.help,
                   "labelnames": list(m.labelnames), "samples": []}
            if m.kind == "histogram":
                rec["buckets"] = list(m.buckets)
            for values, child in sorted(m._series()):
                sample = {"labels": dict(zip(m.labelnames, values))}
                if m.kind == "histogram":
                    cum, s, c = child.snapshot()
                    sample.update(cumulative=cum, sum=s, count=c)
                    ex = child.exemplars()
                    if ex:
                        sample["exemplars"] = {str(i): e
                                               for i, e in ex.items()}
                else:
                    v = child.value
                    # NaN/Inf-safe: json.dump would emit the
                    # nonstandard NaN/Infinity tokens strict parsers
                    # reject
                    sample["value"] = v if math.isfinite(v) else None
                rec["samples"].append(sample)
            metrics.append(rec)
        return {"pid": os.getpid(), "host": socket.gethostname(),
                "time": time.time(), "metrics": metrics}

    def dump_to_file(self, path: str | None = None) -> str:
        """Write the JSON snapshot for this process (atomic rename).
        Default path: $PADDLE_TPU_METRICS_DIR/metrics_<host>_<pid>.json
        — the per-process dump a multi-process job aggregates."""
        if path is None:
            d = os.environ.get("PADDLE_TPU_METRICS_DIR") or "."
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"metrics_{socket.gethostname()}_{os.getpid()}.json")
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path


def aggregate_dumps(dumps: list[dict]) -> dict:
    """Merge per-process JSON dumps: counters and histograms SUM across
    processes; gauges keep the value from the newest dump that carries
    the series (a gauge is a point-in-time reading, not a flow)."""
    merged: dict[str, dict] = {}
    order = sorted(dumps, key=lambda d: d.get("time", 0))
    for dump in order:
        for m in dump.get("metrics", []):
            name = m["name"]
            tgt = merged.get(name)
            if tgt is None:
                tgt = merged[name] = {
                    "name": name, "kind": m["kind"], "help": m["help"],
                    "labelnames": m["labelnames"], "samples": {}}
                if "buckets" in m:
                    tgt["buckets"] = m["buckets"]
            for s in m["samples"]:
                key = tuple(sorted(s["labels"].items()))
                cur = tgt["samples"].get(key)
                if m["kind"] == "histogram":
                    if cur is None:
                        tgt["samples"][key] = {
                            "labels": s["labels"],
                            "cumulative": list(s["cumulative"]),
                            "sum": s["sum"], "count": s["count"]}
                    else:
                        cur["cumulative"] = [
                            a + b for a, b in zip(cur["cumulative"],
                                                  s["cumulative"])]
                        cur["sum"] += s["sum"]
                        cur["count"] += s["count"]
                elif m["kind"] == "gauge" or cur is None:
                    tgt["samples"][key] = dict(s)
                else:  # counter: sum
                    cur["value"] = (cur.get("value") or 0.0) \
                        + (s.get("value") or 0.0)
    out = []
    for name in sorted(merged):
        rec = merged[name]
        rec["samples"] = [rec["samples"][k]
                          for k in sorted(rec["samples"])]
        out.append(rec)
    return {"aggregated_from": len(dumps), "time": time.time(),
            "metrics": out}


# process-wide default registry + module-level shortcuts
REGISTRY = MetricsRegistry()


def counter(name: str, help_: str = "", labels=(),
            always: bool = False) -> Counter:
    return REGISTRY.counter(name, help_, labels, always=always)


def gauge(name: str, help_: str = "", labels=(),
          always: bool = False) -> Gauge:
    return REGISTRY.gauge(name, help_, labels, always=always)


def histogram(name: str, help_: str = "", labels=(),
              buckets=DEFAULT_BUCKETS,
              always: bool = False) -> Histogram:
    return REGISTRY.histogram(name, help_, labels, buckets=buckets,
                              always=always)


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def to_dict() -> dict:
    return REGISTRY.to_dict()


def dump_to_file(path: str | None = None) -> str:
    return REGISTRY.dump_to_file(path)


if __name__ == "__main__":  # python -m paddle_tpu_torch.observability.registry
    import sys
    _dir = sys.argv[1] if len(sys.argv) > 1 else "."
    # bundle-aware job aggregation: metrics_*.json dumps PLUS the
    # metrics.json of every postmortem bundle in the dir, with a
    # "bundles" listing (reason/host/pid/valid) when any exist (the
    # per-rank trace merge waits for the telemetry collector, item 18)
    from .debug import aggregate_with_bundles
    json.dump(aggregate_with_bundles(_dir), sys.stdout, indent=2)
    print()
