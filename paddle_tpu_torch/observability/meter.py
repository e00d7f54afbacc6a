"""Per-tenant usage metering for the serving plane.

The scheduler carries tenant/priority tags on every request; this
module is the accounting layer: Engine/Scheduler/Router hooks land every
request's resource footprint in per-(tenant, tier) registry counters.

What is metered per (tenant, tier):

  * tokens in (prompt) and out (generated);
  * queue seconds (submit -> admission) — what the tenant waited;
  * KV page-seconds (pages held × slot residency) — the device memory a
    tenant's requests occupied, the honest cost of long contexts;
  * request outcomes (completed / rejected / quota / shed / expired /
    preempted / cancelled / failed — a bounded set);
  * a FLOPs estimate from the perf plane's analytic cost registry: the
    prefill bucket's cost plus a per-token share of the decode bucket.

Label cardinality stays bounded: tenant label values pass through
interning — the first ``PADDLE_TPU_TENANT_CAP`` distinct tenants keep
their names, the rest collapse into the ``~other`` overflow bucket
(counted, never dropped). Tier labels clamp to a single digit.

Process-locality: ``METER`` accounts the traffic of *this* process; the
fleet-wide view is assembled collector-side from TSDB series
(``usage_report(tsdb)``), summing across hosts.
"""
from __future__ import annotations

import os
import threading

from . import registry as _obs

__all__ = ["UsageMeter", "METER", "OVERFLOW_TENANT", "OUTCOMES",
           "usage_report"]

OVERFLOW_TENANT = "~other"

# the bounded outcome vocabulary; anything unknown lands on "other"
OUTCOMES = ("completed", "rejected", "quota", "shed", "expired",
            "preempted", "cancelled", "failed", "other")

_TOKENS_IN = _obs.counter(
    "paddle_tpu_tenant_tokens_in_total",
    "prompt tokens submitted, per tenant and tier",
    ["tenant", "tier"])
_TOKENS_OUT = _obs.counter(
    "paddle_tpu_tenant_tokens_out_total",
    "tokens generated, per tenant and tier", ["tenant", "tier"])
_QUEUE_S = _obs.counter(
    "paddle_tpu_tenant_queue_seconds_total",
    "seconds requests waited for admission, per tenant and tier",
    ["tenant", "tier"])
_KV_PAGE_S = _obs.counter(
    "paddle_tpu_tenant_kv_page_seconds_total",
    "KV page-seconds held in slots, per tenant and tier",
    ["tenant", "tier"])
_FLOPS = _obs.counter(
    "paddle_tpu_tenant_flops_total",
    "estimated FLOPs spent (compiled-cost registry), per tenant and "
    "tier", ["tenant", "tier"])
_REQS = _obs.counter(
    "paddle_tpu_tenant_requests_total",
    "request outcomes, per tenant, tier and outcome",
    ["tenant", "tier", "outcome"])
_ROUTER_REQS = _obs.counter(
    "paddle_tpu_tenant_router_requests_total",
    "router relays by tenant and outcome", ["tenant", "outcome"])
_OVERFLOWED = _obs.counter(
    "paddle_tpu_tenant_overflow_total",
    "submissions whose tenant collapsed into the overflow bucket")

# the scheduler's finer-grained finish reasons -> the bounded vocab
_OUTCOME_MAP = {"done": "completed", "expired_in_queue": "expired",
                "deadline": "preempted", "queue_full": "rejected",
                "draining": "rejected", "error": "failed"}


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _tier(priority) -> str:
    try:
        p = int(priority)
    except (TypeError, ValueError):
        return "?"
    return str(p) if 0 <= p <= 8 else ("9+" if p > 8 else "?")


def normalize_outcome(raw) -> str:
    out = _OUTCOME_MAP.get(str(raw), str(raw))
    return out if out in OUTCOMES else "other"


class UsageMeter:
    """See module docstring. Cheap enough for the submit path: one
    set lookup + a few counter incs per event."""

    def __init__(self, cap: int | None = None):
        if cap is None:
            cap = _env_int("PADDLE_TPU_TENANT_CAP", 64)
        self.cap = max(1, int(cap))
        self._lock = threading.Lock()
        self._tenants: set[str] = set()
        self._overflowed: set[str] = set()

    def intern(self, tenant) -> str:
        """The label value for a tenant: its own name while under the
        cap, the overflow bucket after — bounded cardinality no matter
        what the frontend sends."""
        t = str(tenant or "default")
        with self._lock:
            if t in self._tenants:
                return t
            if len(self._tenants) < self.cap:
                self._tenants.add(t)
                return t
            if t not in self._overflowed:
                self._overflowed.add(t)
                _OVERFLOWED.inc()
        return OVERFLOW_TENANT

    # -- hooks ---------------------------------------------------------
    def note_submitted(self, tenant, priority, tokens_in: int):
        """Engine.submit: prompt tokens offered (counted even when the
        scheduler later rejects — offered load is what billing sees)."""
        _TOKENS_IN.labels(tenant=self.intern(tenant),
                          tier=_tier(priority)).inc(max(0, int(tokens_in)))

    def note_outcome(self, tenant, priority, outcome,
                     tokens_out: int = 0, queue_s: float = 0.0,
                     kv_page_s: float = 0.0):
        """Scheduler finish/reject: one terminal outcome per request
        plus the resources it consumed getting there."""
        t = self.intern(tenant)
        tier = _tier(priority)
        _REQS.labels(tenant=t, tier=tier,
                     outcome=normalize_outcome(outcome)).inc()
        if tokens_out > 0:
            _TOKENS_OUT.labels(tenant=t, tier=tier).inc(int(tokens_out))
        if queue_s > 0:
            _QUEUE_S.labels(tenant=t, tier=tier).inc(float(queue_s))
        if kv_page_s > 0:
            _KV_PAGE_S.labels(tenant=t, tier=tier).inc(float(kv_page_s))

    def note_flops(self, tenant, priority, flops: float):
        if flops and flops > 0:
            _FLOPS.labels(tenant=self.intern(tenant),
                          tier=_tier(priority)).inc(float(flops))

    def note_routed(self, tenant, outcome):
        """One generate answered by a router, by its final outcome."""
        _ROUTER_REQS.labels(tenant=self.intern(tenant),
                            outcome=normalize_outcome(outcome)).inc()

    # -- local report ----------------------------------------------------
    def report(self) -> dict:
        """This process's usage, per (tenant, tier), read back from the
        registry children (one source of truth — parity with what the
        TSDB sees)."""
        out: dict[str, dict] = {}

        def add(metric, field):
            names = metric.labelnames
            for values, child in metric._series():
                labels = dict(zip(names, values))
                v = float(child.value)
                key = f"{labels.get('tenant', '')}/{labels.get('tier', '')}"
                slot = out.setdefault(key, {"tenant": labels.get(
                    "tenant", ""), "tier": labels.get("tier", "")})
                if field == "outcomes":
                    slot.setdefault("outcomes", {})[
                        labels.get("outcome", "?")] = v
                else:
                    slot[field] = slot.get(field, 0.0) + v

        add(_TOKENS_IN, "tokens_in")
        add(_TOKENS_OUT, "tokens_out")
        add(_QUEUE_S, "queue_seconds")
        add(_KV_PAGE_S, "kv_page_seconds")
        add(_FLOPS, "flops")
        add(_REQS, "outcomes")
        return {"tenants": out, "interned": len(self._tenants),
                "cap": self.cap}


# one process-wide meter: engine/scheduler/router hooks share it so a
# process's tenants intern once
METER = UsageMeter()


def usage_report(tsdb=None, window: float | None = None) -> dict:
    """The ``usage_report`` verb body. With a TSDB (collector-side):
    fleet-wide usage summed across processes from the tenant series —
    latest totals plus, when ``window`` is given, trailing-window
    deltas. Without one: this process's local meter."""
    if tsdb is None:
        return {"scope": "process", **METER.report()}
    gb = ("tenant", "tier")
    names = {"tokens_in": "paddle_tpu_tenant_tokens_in_total",
             "tokens_out": "paddle_tpu_tenant_tokens_out_total",
             "queue_seconds": "paddle_tpu_tenant_queue_seconds_total",
             "kv_page_seconds":
                 "paddle_tpu_tenant_kv_page_seconds_total",
             "flops": "paddle_tpu_tenant_flops_total"}
    out: dict[str, dict] = {}

    def slot(g):
        key = "/".join(g)
        return out.setdefault(key, {"tenant": g[0], "tier": g[1]})

    for field, name in names.items():
        for g, v in tsdb.latest_by(name, gb).items():
            slot(g)[field] = v
        if window:
            for g, v in tsdb.delta_by(name, window, gb).items():
                slot(g)[f"{field}_window"] = v
    for g, v in tsdb.latest_by("paddle_tpu_tenant_requests_total",
                               ("tenant", "tier", "outcome")).items():
        slot(g[:2]).setdefault("outcomes", {})[g[2]] = v
    rep = {"scope": "fleet", "tenants": out}
    if window:
        rep["window_s"] = float(window)
    return rep
