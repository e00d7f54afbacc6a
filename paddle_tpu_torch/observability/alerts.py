"""Declarative alert rules evaluated over the collector TSDB
(counterpart of ``paddle_tpu/observability/alerts.py``; the rule JSON
is the same).

The time-series plane (``observability.timeseries``) gives the fleet
history; this module makes it proactive. An ``AlertManager`` hosted
next to the collector evaluates a rule set on a cadence and walks
each alert instance through the pending → firing → resolved
lifecycle, so an SLO burn surfaces *before* a human looks.

Rule kinds:

  * ``threshold`` — a metric's latest value or trailing-window rate
    compared against a bound (queue depth too deep, drop counter
    rising);
  * ``absence`` — liveness: a process the collector knows stopped
    reporting for longer than ``max_age_s``. Uses the same
    ``last_seen`` signal fleet-state GC retires processes by — size
    the GC window (``PADDLE_TPU_TELEMETRY_RETIRE``) longer than
    ``max_age_s + for_s`` or the alert never gets to fire;
  * ``burn_rate`` — the SRE-workbook multi-window, multi-burn-rate
    SLO rule: error ratio = bad/(bad+good) over a short AND a long
    trailing window, each divided by the error budget; fires only
    when BOTH windows burn faster than ``factor``× budget (the short
    window gives fast detection, the long window keeps a transient
    blip from paging). ``group_by`` splits the evaluation per label
    value — per-tenant rules fire for the tenant that burns, not the
    fleet aggregate one loud tenant hides in.

Lifecycle: a true condition creates a *pending* instance; still true
``for_s`` later it transitions to *firing* (fleet event + flight
event, and optionally a debug bundle — symptom to postmortem
artifact with no human in the loop). A firing instance must stay
clear for ``resolve_s`` before it *resolves* (flap damping); a
pending one that clears simply drops. One event per transition per
instance — re-notification only after a genuine re-fire.

Rules load from JSON (``PADDLE_TPU_ALERTS_RULES`` or
``AlertRule.from_dict``); ``default_rules()`` ships the fleet SLO
burn-rate, agent-liveness, and per-tenant burn-rate rules.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import debug as _debug
from . import registry as _obs
from .agent import publish_event as _publish_event
from .flight import RECORDER as _flight

__all__ = ["AlertRule", "AlertManager", "default_rules", "load_rules"]

_EVALS = _obs.counter(
    "paddle_tpu_alerts_evaluations_total",
    "alert rule-set evaluation passes")
_TRANSITIONS = _obs.counter(
    "paddle_tpu_alerts_transitions_total",
    "alert lifecycle transitions", ["state"])
_FIRING = _obs.gauge(
    "paddle_tpu_alerts_firing",
    "alert instances currently firing")

_OPS = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class AlertRule:
    """One declarative rule; see module docstring for kinds."""

    def __init__(self, name: str, kind: str, *,
                 metric: str | None = None,
                 labels: dict | None = None,
                 op: str = ">", value: float = 0.0,
                 mode: str = "latest", window: float = 60.0,
                 max_age_s: float = 30.0,
                 good_metric: str | None = None,
                 bad_metric: str | None = None,
                 good_labels: dict | None = None,
                 bad_labels: dict | None = None,
                 budget: float = 0.01, factor: float = 14.4,
                 short_window: float = 300.0,
                 long_window: float = 3600.0,
                 min_bad: float = 1.0,
                 group_by=None,
                 for_s: float = 0.0, resolve_s: float = 0.0,
                 severity: str = "warning",
                 capture_bundle: bool = False):
        if kind not in ("threshold", "absence", "burn_rate"):
            raise ValueError(f"unknown alert kind {kind!r}")
        if kind == "threshold" and not metric:
            raise ValueError(f"rule {name!r}: threshold needs metric")
        if kind == "burn_rate" and not bad_metric:
            raise ValueError(f"rule {name!r}: burn_rate needs "
                             f"bad_metric")
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: unknown op {op!r}")
        if mode not in ("latest", "rate"):
            raise ValueError(f"rule {name!r}: unknown mode {mode!r}")
        self.name = str(name)
        self.kind = kind
        self.metric = metric
        self.labels = dict(labels or {})
        self.op = op
        self.value = float(value)
        self.mode = mode
        self.window = float(window)
        self.max_age_s = float(max_age_s)
        self.good_metric = good_metric
        self.bad_metric = bad_metric
        self.good_labels = dict(good_labels or {})
        self.bad_labels = dict(bad_labels or {})
        self.budget = max(1e-9, float(budget))
        self.factor = float(factor)
        self.short_window = float(short_window)
        self.long_window = float(long_window)
        self.min_bad = float(min_bad)
        self.group_by = list(group_by or [])
        self.for_s = max(0.0, float(for_s))
        self.resolve_s = max(0.0, float(resolve_s))
        self.severity = str(severity)
        self.capture_bundle = bool(capture_bundle)

    @classmethod
    def from_dict(cls, d: dict) -> "AlertRule":
        d = dict(d)
        return cls(d.pop("name"), d.pop("kind"), **d)

    def to_dict(self) -> dict:
        out = {"name": self.name, "kind": self.kind,
               "severity": self.severity, "for_s": self.for_s}
        if self.kind == "threshold":
            out.update(metric=self.metric, op=self.op,
                       value=self.value, mode=self.mode,
                       window=self.window)
        elif self.kind == "absence":
            out.update(max_age_s=self.max_age_s)
        else:
            out.update(bad_metric=self.bad_metric,
                       good_metric=self.good_metric,
                       budget=self.budget, factor=self.factor,
                       short_window=self.short_window,
                       long_window=self.long_window,
                       group_by=self.group_by)
        return out

    # -- evaluation: {instance_key: (labels, measured_value)} ----------
    def evaluate(self, tsdb, fleet: dict | None) -> dict:
        if self.kind == "absence":
            return self._eval_absence(fleet)
        if tsdb is None:
            return {}
        if self.kind == "threshold":
            return self._eval_threshold(tsdb)
        return self._eval_burn(tsdb)

    def _eval_threshold(self, tsdb) -> dict:
        if self.group_by:
            if self.mode == "rate":
                vals = {g: d / max(1e-9, self.window)
                        for g, d in tsdb.delta_by(
                            self.metric, self.window, self.group_by,
                            self.labels).items()}
            else:
                vals = tsdb.latest_by(self.metric, self.group_by,
                                      self.labels)
            out = {}
            for g, v in vals.items():
                if _OPS[self.op](v, self.value):
                    labels = dict(zip(self.group_by, g))
                    out["|".join(g)] = (labels, v)
            return out
        v = tsdb.rate(self.metric, self.window, self.labels) \
            if self.mode == "rate" \
            else tsdb.latest(self.metric, self.labels)
        return {"": ({}, v)} if _OPS[self.op](v, self.value) else {}

    def _eval_absence(self, fleet: dict | None) -> dict:
        out = {}
        for p in (fleet or {}).get("procs") or ():
            age = p.get("age_s")
            if age is not None and age > self.max_age_s:
                labels = {"host": str(p.get("host")),
                          "pid": str(p.get("pid")),
                          "role": str(p.get("role"))}
                key = f"{labels['host']}:{labels['pid']}"
                out[key] = (labels, float(age))
        return out

    def _burn(self, tsdb, window: float) -> dict:
        """{group: burn multiple} over one trailing window."""
        gb = self.group_by or []
        if gb:
            bad = tsdb.delta_by(self.bad_metric, window, gb,
                                self.bad_labels)
            good = tsdb.delta_by(self.good_metric, window, gb,
                                 self.good_labels) \
                if self.good_metric else {}
        else:
            bad = {(): tsdb.delta(self.bad_metric, window,
                                  self.bad_labels)}
            good = {(): tsdb.delta(self.good_metric, window,
                                   self.good_labels)
                    if self.good_metric else 0.0}
        out = {}
        for g, b in bad.items():
            if b < self.min_bad:
                continue
            total = b + max(0.0, good.get(g, 0.0))
            ratio = b / total if total > 0 else 0.0
            out[g] = ratio / self.budget
        return out

    def _eval_burn(self, tsdb) -> dict:
        short = self._burn(tsdb, self.short_window)
        if not short:
            return {}
        long_ = self._burn(tsdb, self.long_window)
        out = {}
        for g, s_burn in short.items():
            l_burn = long_.get(g, 0.0)
            if s_burn >= self.factor and l_burn >= self.factor:
                labels = dict(zip(self.group_by, g))
                out["|".join(g)] = (labels, s_burn)
        return out


class _Instance:
    __slots__ = ("rule", "key", "labels", "state", "since",
                 "firing_since", "clear_since", "value", "bundle")

    def __init__(self, rule: AlertRule, key: str, labels: dict,
                 now: float):
        self.rule = rule
        self.key = key
        self.labels = labels
        self.state = "pending"
        self.since = now
        self.firing_since: float | None = None
        self.clear_since: float | None = None
        self.value = 0.0
        self.bundle: str | None = None

    def to_dict(self) -> dict:
        return {"rule": self.rule.name, "kind": self.rule.kind,
                "severity": self.rule.severity, "state": self.state,
                "labels": dict(self.labels), "since": self.since,
                "firing_since": self.firing_since,
                "value": self.value, "bundle": self.bundle}


class AlertManager:
    """Evaluates a rule set over a TSDB + fleet snapshot on a cadence.

    Never call ``evaluate`` while holding the collector lock: a
    firing rule may write a debug bundle (disk IO) and ``fleet_fn``
    itself takes that lock. The collector calls ``maybe_evaluate``
    after releasing its lock on each ingest; the standalone
    ``CollectorServer`` loop drives it between pushes too."""

    def __init__(self, tsdb=None, fleet_fn=None, rules=None,
                 eval_s: float | None = None, event_cb=None,
                 history_max: int = 128):
        if eval_s is None:
            eval_s = _env_float("PADDLE_TPU_ALERTS_EVAL", 5.0)
        if rules is None:
            rules = load_rules()
        self.tsdb = tsdb
        self.fleet_fn = fleet_fn
        self.rules = list(rules)
        self.eval_s = max(0.0, float(eval_s))
        # event_cb(dict): the hosting collector mirrors transitions
        # into its recent-events feed (tel_fleet) even when no
        # local agent is armed
        self.event_cb = event_cb
        self._lock = threading.Lock()
        self._active: dict[tuple, _Instance] = {}
        self._history: deque = deque(maxlen=max(8, history_max))
        self._last_eval = 0.0
        self.counts = {"evaluations": 0, "pending": 0, "firing": 0,
                       "resolved": 0, "bundles": 0}

    # -- cadence -------------------------------------------------------
    def maybe_evaluate(self, now: float | None = None) -> bool:
        if self.eval_s <= 0:
            return False
        t = time.monotonic()
        with self._lock:
            if t - self._last_eval < self.eval_s:
                return False
            self._last_eval = t
        self.evaluate(now)
        return True

    # -- one pass ------------------------------------------------------
    def evaluate(self, now: float | None = None):
        now = time.time() if now is None else float(now)
        fleet = None
        if any(r.kind == "absence" for r in self.rules) \
                and self.fleet_fn is not None:
            fleet = self.fleet_fn()
        true_now: dict[tuple, tuple] = {}
        for rule in self.rules:
            try:
                hits = rule.evaluate(self.tsdb, fleet)
            except Exception:
                continue  # one bad rule must not kill the pass
            for key, (labels, value) in hits.items():
                true_now[(rule.name, key)] = (rule, labels, value)
        transitions = []
        with self._lock:
            self.counts["evaluations"] += 1
            for ikey, (rule, labels, value) in true_now.items():
                inst = self._active.get(ikey)
                if inst is None:
                    inst = self._active[ikey] = _Instance(
                        rule, ikey[1], labels, now)
                    self.counts["pending"] += 1
                    transitions.append(("pending", inst))
                inst.value = value
                inst.clear_since = None
                if inst.state == "pending" \
                        and now - inst.since >= rule.for_s:
                    inst.state = "firing"
                    inst.firing_since = now
                    self.counts["firing"] += 1
                    transitions.append(("firing", inst))
            for ikey, inst in list(self._active.items()):
                if ikey in true_now:
                    continue
                if inst.state == "pending":
                    del self._active[ikey]  # never fired: just drop
                    continue
                if inst.clear_since is None:
                    inst.clear_since = now
                if now - inst.clear_since >= inst.rule.resolve_s:
                    inst.state = "resolved"
                    self.counts["resolved"] += 1
                    transitions.append(("resolved", inst))
                    self._history.append(inst.to_dict())
                    del self._active[ikey]
            _FIRING.set(sum(1 for i in self._active.values()
                            if i.state == "firing"))
        for state, inst in transitions:
            self._notify(state, inst)

    def _notify(self, state: str, inst: _Instance):
        _TRANSITIONS.labels(state=state).inc()
        attrs = {"rule": inst.rule.name, "state": state,
                 "severity": inst.rule.severity,
                 "value": round(float(inst.value), 4),
                 **inst.labels}
        _flight.record("alerts", f"alert_{state}", **attrs)
        if state == "firing" and inst.rule.capture_bundle:
            # symptom -> postmortem artifact with no human in the
            # loop; best-effort, never blocks the pass on IO errors
            inst.bundle = _debug.try_write_bundle(
                f"alert:{inst.rule.name}")
            if inst.bundle:
                self.counts["bundles"] += 1
                attrs["bundle"] = inst.bundle
        if state != "pending":
            _publish_event(f"alert_{state}", **attrs)
        if self.event_cb is not None:
            try:
                self.event_cb({"kind": f"alert_{state}",
                               "attrs": attrs})
            except Exception:
                pass

    # -- reads ---------------------------------------------------------
    def active(self) -> list[dict]:
        with self._lock:
            return sorted((i.to_dict() for i in
                           self._active.values()),
                          key=lambda d: (d["rule"], d["labels"].get(
                              "tenant", ""), d["since"]))

    def state(self) -> dict:
        with self._lock:
            return {"active": [i.to_dict()
                               for i in self._active.values()],
                    "history": list(self._history),
                    "rules": [r.to_dict() for r in self.rules],
                    "eval_s": self.eval_s,
                    "counts": dict(self.counts)}


def default_rules() -> list[AlertRule]:
    """The shipped rule set: fleet SLO burn rate, agent liveness, and
    the per-tenant burn rate that keeps one tenant's pain visible
    under a healthy fleet aggregate."""
    return [
        AlertRule(
            "slo-burn-rate", "burn_rate",
            bad_metric="paddle_tpu_slo_deadline_missed_total",
            good_metric="paddle_tpu_slo_deadline_met_total",
            budget=0.01, factor=14.4,
            short_window=300.0, long_window=3600.0,
            for_s=15.0, resolve_s=60.0, severity="page",
            capture_bundle=True),
        AlertRule(
            "agent-absent", "absence", max_age_s=30.0,
            for_s=10.0, resolve_s=30.0, severity="warning"),
        AlertRule(
            "tenant-burn-rate", "burn_rate",
            bad_metric="paddle_tpu_tenant_requests_total",
            bad_labels={"outcome": ["rejected", "shed", "expired",
                                    "quota", "preempted"]},
            good_metric="paddle_tpu_tenant_requests_total",
            good_labels={"outcome": ["completed"]},
            group_by=["tenant"],
            budget=0.05, factor=6.0,
            short_window=300.0, long_window=1800.0,
            for_s=15.0, resolve_s=60.0, severity="warning"),
    ]


def load_rules(path: str | None = None) -> list[AlertRule]:
    """Rules from a JSON file (a list of rule dicts), else the
    defaults. ``PADDLE_TPU_ALERTS_RULES`` names the file for hosted
    collectors; a broken file falls back to the defaults rather than
    silently disabling alerting."""
    path = path or os.environ.get("PADDLE_TPU_ALERTS_RULES") or None
    if not path:
        return default_rules()
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        return [AlertRule.from_dict(d) for d in raw]
    except (OSError, ValueError, KeyError, TypeError):
        return default_rules()
