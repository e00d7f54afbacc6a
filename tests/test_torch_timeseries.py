"""The port's fleet time-series plane (paddle_tpu_torch/observability/
timeseries.py, alerts.py, meter.usage_report and the collector's TSDB
verbs) on the CPU: the cases of tests/test_timeseries.py on the port
(CRC'd block files, torn-tail truncation, restart replay, downsample
compaction, byte-budgeted retention; threshold / absence / burn-rate
alerts with debug-bundle capture, the burn-rate chaos drill on the
port's tiny engine; per-tenant metering and the fleet usage report;
the two ``top`` pane cases). Cross-package: a TSDB directory written
by the port answers the JAX package's range / rate / quantile / latest
queries with the same values, and the reverse; the block files of the
same appends are the same bytes; ``meter.note_routed`` counts as the reference's; every
``top`` renderer's text is the reference's, byte for byte, for the same
reply dicts. Tolerance: equality (the same float arithmetic on both
sides); 1e-12 relative where a rate or quantile is computed.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.observability import meter as meter_mod
from paddle_tpu_torch.observability import registry as _obs
from paddle_tpu_torch.observability.alerts import (AlertManager, AlertRule,
                                             default_rules, load_rules)
from paddle_tpu_torch.observability.collector import (CollectorServer,
                                                TelemetryCollector)
from paddle_tpu_torch.observability.meter import UsageMeter, usage_report
from paddle_tpu_torch.observability.timeseries import (TimeSeriesDB,
                                                 committed_records,
                                                 hist_quantile,
                                                 series_key)
from paddle_tpu_torch.serving import (Engine, GPTDecodeModel, LoadGenerator,
                                TrafficConfig, slo_report)

# metric time is synthetic throughout (the TSDB trusts pusher clocks):
# a fixed epoch keeps every windowed assertion deterministic
T0 = 1_700_000_000.0


def _cval(name: str, **labels) -> float:
    m = _obs.REGISTRY.get(name)
    if m is None:
        return 0.0
    child = m.labels(**labels) if labels else m
    return float(child.value)


def _counter_entries(name, vals):
    return [(name, {"host": "h", "pid": str(i), "role": "w"},
             "counter", float(v), None)
            for i, v in enumerate(vals)]


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


# ---------------------------------------------------------------------------
# TSDB core: ingest, tiers, queries
# ---------------------------------------------------------------------------

def test_series_key_is_canonical():
    assert series_key("m", None) == "m"
    assert series_key("m", {"b": "2", "a": "1"}) == 'm{a="1",b="2"}'
    assert series_key("m", {"a": "1", "b": "2"}) == \
        series_key("m", {"b": "2", "a": "1"})


def test_append_range_latest_delta_rate():
    db = TimeSeriesDB()  # memory-only
    for i in range(10):
        db.append(T0 + i, _counter_entries("reqs_total",
                                           [i * 2, i * 3]))
    assert {s["name"] for s in db.series()} == {"reqs_total"}
    assert len(db.series("reqs_total")) == 2
    # latest sums across matching series: 9*2 + 9*3
    assert db.latest("reqs_total") == 45.0
    assert db.latest("reqs_total", {"pid": "0"}) == 18.0
    rng = db.range("reqs_total", {"pid": "1"}, T0 + 2, T0 + 4)
    assert len(rng) == 1
    assert rng[0]["points"] == [(T0 + 2, 6.0), (T0 + 3, 9.0),
                                (T0 + 4, 12.0)]
    # delta over the trailing window (anchored at the newest sample)
    assert db.delta("reqs_total", 5.0) == pytest.approx(
        (18 - 8) + (27 - 12))
    assert db.rate("reqs_total", 5.0) == pytest.approx(25 / 5.0)
    # a series born inside the window counts from zero
    db.append(T0 + 9, [("late_total", {"pid": "9"}, "counter",
                        7.0, None)])
    assert db.delta("late_total", 5.0) == 7.0


def test_latest_by_and_delta_by_group():
    db = TimeSeriesDB()
    for i in range(5):
        db.append(T0 + i, [
            ("tok_total", {"tenant": "web", "host": "h1"},
             "counter", float(10 * i), None),
            ("tok_total", {"tenant": "web", "host": "h2"},
             "counter", float(i), None),
            ("tok_total", {"tenant": "batch", "host": "h1"},
             "counter", float(100 * i), None)])
    by = db.latest_by("tok_total", ("tenant",))
    assert by == {("web",): 44.0, ("batch",): 400.0}
    d = db.delta_by("tok_total", 2.0, ("tenant",))
    assert d == {("web",): pytest.approx(22.0),
                 ("batch",): pytest.approx(200.0)}


def test_histogram_quantile_over_window():
    db = TimeSeriesDB()
    buckets = (0.01, 0.1, 1.0)
    # cumulative counts: all mass in the 0.1 bucket by the end
    db.append(T0, [("lat_seconds", {"h": "1"}, "histogram",
                    ((0.0, 0.0, 0.0, 0.0), 0.0, 0.0), buckets)])
    db.append(T0 + 60, [("lat_seconds", {"h": "1"}, "histogram",
                         ((2.0, 90.0, 98.0, 100.0), 5.0, 100.0),
                         buckets)])
    assert db.quantile("lat_seconds", 0.5, 120.0) == 0.1
    assert db.quantile("lat_seconds", 0.99, 120.0) == 1.0
    # histogram range points surface the count (sparkline-friendly)
    rng = db.range("lat_seconds", None, T0, T0 + 60)
    assert rng[0]["points"][-1] == (T0 + 60, 100.0)
    assert db.quantile("lat_seconds", 0.5, 120.0,
                       {"h": "nope"}) is None
    assert hist_quantile((1.0,), [0], 0.9) is None


def test_raw_window_downsamples_to_mid_tier():
    db = TimeSeriesDB(raw_window_s=30.0)
    for i in range(120):
        db.append(T0 + i, [("g", {}, "gauge", float(i), None)])
    pts = db.range("g", None, T0, T0 + 119)[0]["points"]
    # old samples collapsed to one per 10s bucket, fresh ones raw
    old = [p for p in pts if p[0] < T0 + 89]
    fresh = [p for p in pts if p[0] >= T0 + 89]
    assert len(fresh) >= 30
    assert len(old) <= 10
    # last-per-bucket wins, values still monotone
    assert [v for _, v in pts] == sorted(v for _, v in pts)


# ---------------------------------------------------------------------------
# TSDB disk: blocks, torn tail, replay, retention
# ---------------------------------------------------------------------------

def _fill(db, n, t0=T0, names=("a_total", "b_total")):
    for i in range(n):
        db.append(t0 + i, [(nm, {"pid": "1"}, "counter",
                            float(i), None) for nm in names])


def test_block_seal_and_restart_replay(tmp_path):
    d = str(tmp_path / "tsdb")
    db = TimeSeriesDB(dir_=d, block_bytes=4096)
    _fill(db, 300)
    assert db.counts["sealed"] > 0
    st = db.stats()
    assert st["bytes_on_disk"] > 0 and st["blocks"]
    before = db.range("a_total", None, T0, T0 + 299)[0]["points"]
    latest = db.latest("a_total")
    db.close()
    # a fresh store on the same dir replays every committed record
    db2 = TimeSeriesDB(dir_=d, block_bytes=4096)
    assert db2.counts["replayed"] > 0
    assert db2.counts["torn"] == 0
    assert db2.latest("a_total") == latest
    after = db2.range("a_total", None, T0, T0 + 299)[0]["points"]
    # sealed blocks are 10s-downsampled: the replayed view is the
    # persisted resolution, and every persisted point matches
    assert set(after) <= set(before)
    assert len(after) >= 300 // 10
    # the store keeps accepting writes after replay
    db2.append(T0 + 300, [("a_total", {"pid": "1"}, "counter",
                           300.0, None)])
    assert db2.latest("a_total") == 300.0
    db2.close()


def test_torn_tail_truncated_and_commit_prefix_survives(tmp_path):
    d = str(tmp_path / "tsdb")
    db = TimeSeriesDB(dir_=d, block_bytes=1 << 20)  # never seals
    _fill(db, 50, names=("m_total",))
    db.close()
    active = os.path.join(d, "active.tsb")
    good = os.path.getsize(active)
    with open(active, "ab") as f:
        f.write(b"\x00garbage-torn-tail")
    torn0 = _cval("paddle_tpu_tsdb_torn_tail_truncated_total")
    db2 = TimeSeriesDB(dir_=d)
    assert db2.counts["torn"] == 1
    assert _cval("paddle_tpu_tsdb_torn_tail_truncated_total") \
        - torn0 == 1
    # the torn bytes are physically gone; committed prefix intact
    assert os.path.getsize(active) == good
    assert db2.latest("m_total") == 49.0
    assert db2.counts["replayed"] == 50
    db2.close()


def test_corrupt_crc_mid_file_stops_replay_at_last_good(tmp_path):
    d = str(tmp_path / "tsdb")
    db = TimeSeriesDB(dir_=d, block_bytes=1 << 20)
    _fill(db, 20, names=("m_total",))
    db.close()
    active = os.path.join(d, "active.tsb")
    blob = bytearray(open(active, "rb").read())
    blob[len(blob) // 2] ^= 0xFF  # flip one payload byte mid-file
    with open(active, "wb") as f:
        f.write(bytes(blob))
    db2 = TimeSeriesDB(dir_=d)
    # replay stops at the first CRC mismatch and truncates there
    assert db2.counts["torn"] == 1
    assert 0 < db2.counts["replayed"] < 20
    assert os.path.getsize(active) < len(blob)
    db2.close()


def test_retention_compacts_then_deletes_oldest(tmp_path):
    d = str(tmp_path / "tsdb")
    db = TimeSeriesDB(dir_=d, block_bytes=4096,
                      retention_bytes=16 * 1024)
    _fill(db, 3000)
    st = db.stats()
    # enforcement runs at seal time: the unsealed active tail may ride
    # up to one block above the budget between seals
    assert st["bytes_on_disk"] <= 16 * 1024 + 4096
    # degrade-before-delete: oldest raw blocks were 5m-compacted, and
    # under sustained pressure compacted blocks were then dropped
    assert db.counts["compacted"] > 0
    assert db.counts["deleted"] > 0
    # the newest data is still at full fidelity
    assert db.latest("a_total") == 2999.0
    db.close()
    # survivors still replay cleanly
    db2 = TimeSeriesDB(dir_=d)
    assert db2.latest("a_total") == 2999.0
    db2.close()


def test_block_files_are_crc_framed(tmp_path):
    d = str(tmp_path / "tsdb")
    db = TimeSeriesDB(dir_=d, block_bytes=4096)
    _fill(db, 300)
    db.close()
    blocks = [fn for fn in os.listdir(d) if fn.startswith("block-")]
    assert blocks
    blob = open(os.path.join(d, sorted(blocks)[0]), "rb").read()
    payloads = [json.loads(p) for p, _ in committed_records(blob)]
    assert payloads, "no committed records in sealed block"
    # every record carries t + samples; the first carries series meta
    assert all("t" in r and "s" in r for r in payloads)
    assert "m" in payloads[0]


# ---------------------------------------------------------------------------
# collector integration: ingest lands in the TSDB, verbs serve it
# ---------------------------------------------------------------------------

def _dump(t, metrics):
    """Minimal registry-dump shape (registry.to_dict contract)."""
    return {"time": t, "metrics": metrics}


def _push(col, t, value, host="h1", pid=7, role="worker",
          name="paddle_tpu_unit_total"):
    col.ingest({
        "op": "tel_push", "host": host, "pid": pid, "role": role,
        "anchor": 0.0, "offset": 0.0, "rtt": 0.001,
        "wall": time.time(), "spans": [], "flight": [], "events": [],
        "dropped": {},
        "metrics": _dump(t, [
            {"name": name, "kind": "counter", "labelnames": [],
             "samples": [{"labels": {}, "value": value}]}])})


def test_collector_ingest_lands_in_tsdb_with_proc_labels():
    col = TelemetryCollector(sample=0.0, alerts=None)
    _push(col, T0, 5.0)
    _push(col, T0 + 10, 9.0)
    srs = col.tsdb.series("paddle_tpu_unit_total")
    assert len(srs) == 1
    assert srs[0]["labels"] == {"host": "h1", "pid": "7",
                                "role": "worker"}
    assert col.tsdb.latest("paddle_tpu_unit_total") == 9.0
    # window edge sits ON the first sample -> a true 4.0 increase;
    # a wider window treats the series as born inside it (counts 9.0)
    assert col.tsdb.delta("paddle_tpu_unit_total", 10.0) == 4.0
    assert col.tsdb.delta("paddle_tpu_unit_total", 60.0) == 9.0


def test_tsdb_query_verb_all_queries_and_errors():
    col = TelemetryCollector(sample=0.0, alerts=None)
    _push(col, T0, 5.0)
    _push(col, T0 + 100, 25.0)
    q = col.tsdb_query
    assert any(s["name"] == "paddle_tpu_unit_total"
               for s in q({"query": "series"})["series"])
    assert q({"query": "latest",
              "metric": "paddle_tpu_unit_total"})["value"] == 25.0
    pts = q({"query": "range", "metric": "paddle_tpu_unit_total",
             "window": 200})["points"]
    assert pts and pts[0]["points"][-1] == (T0 + 100, 25.0)
    assert q({"query": "delta", "metric": "paddle_tpu_unit_total",
              "window": 100})["value"] == 20.0
    assert q({"query": "rate", "metric": "paddle_tpu_unit_total",
              "window": 100})["value"] == pytest.approx(0.2)
    assert "error" in q({"query": "nope", "metric": "x"})
    assert "error" in q({"query": "latest"})  # metric required
    col2 = TelemetryCollector(sample=0.0, tsdb=None, alerts=None)
    col2.tsdb = None  # simulate PADDLE_TPU_TSDB=0
    assert "error" in col2.tsdb_query({"query": "latest",
                                       "metric": "x"})


def test_tsdb_query_over_the_wire():
    from paddle_tpu_torch.distributed.fleet.runtime.rpc import RpcClient

    col = TelemetryCollector(sample=0.0, alerts=None)
    _push(col, T0, 3.0)
    with CollectorServer(collector=col) as srv:
        cli = RpcClient(srv.endpoint)
        try:
            rep = cli.call({"op": "tsdb_query", "query": "latest",
                            "metric": "paddle_tpu_unit_total"})
            assert rep["value"] == 3.0
            rep = cli.call({"op": "alerts"})
            assert "alerts" in rep
            rep = cli.call({"op": "usage_report"})
            assert rep["usage"]["scope"] == "fleet"
        finally:
            cli.close()


def test_collector_restart_serves_pre_restart_history(tmp_path):
    """Acceptance: history written before a collector restart is
    queryable after it — the TSDB dir is the durable state."""
    d = str(tmp_path / "tsdb")
    col = TelemetryCollector(sample=0.0,
                             tsdb=TimeSeriesDB(dir_=d,
                                               block_bytes=4096),
                             alerts=None)
    for i in range(200):
        _push(col, T0 + i, float(i))
    pre = col.tsdb.range("paddle_tpu_unit_total", None,
                         T0, T0 + 199)[0]["points"]
    col.close()
    # "restart": a new collector process opens the same dir
    col2 = TelemetryCollector(sample=0.0,
                              tsdb=TimeSeriesDB(dir_=d,
                                                block_bytes=4096),
                              alerts=None)
    rep = col2.tsdb_query({"query": "range",
                           "metric": "paddle_tpu_unit_total",
                           "start": T0, "end": T0 + 199})
    after = rep["points"][0]["points"]
    assert after and set(after) <= set(pre)
    assert after[-1] == pre[-1]  # the latest sample survives exactly
    # and new pushes append on top of the replayed history
    _push(col2, T0 + 200, 777.0)
    assert col2.tsdb.latest("paddle_tpu_unit_total") == 777.0
    col2.close()


def test_collector_gc_retires_stale_procs():
    col = TelemetryCollector(sample=0.0, alerts=None, retire_s=0.05)
    _push(col, T0, 1.0, host="gone", pid=1)
    _push(col, T0, 1.0, host="alive", pid=2)
    assert len(col.fleet()["procs"]) == 2
    r0 = _cval("paddle_tpu_telemetry_procs_retired_total")
    time.sleep(0.1)
    _push(col, T0 + 1, 2.0, host="alive", pid=2)  # refreshes alive
    col.sweep(force=True)
    fl = col.fleet()
    assert [p["host"] for p in fl["procs"]] == ["alive"]
    assert col.counts["procs_retired"] == 1
    assert _cval("paddle_tpu_telemetry_procs_retired_total") - r0 == 1
    assert any(e["kind"] == "proc_retired"
               for e in fl["recent_events"])
    # history outlives the fleet row: the TSDB still has the series
    assert col.tsdb.latest("paddle_tpu_unit_total",
                           {"host": "gone"}) == 1.0


def test_collector_gc_disabled_with_zero_retire():
    col = TelemetryCollector(sample=0.0, alerts=None, retire_s=0.0)
    _push(col, T0, 1.0, host="gone", pid=1)
    time.sleep(0.05)
    col.sweep(force=True)
    assert len(col.fleet()["procs"]) == 1
    assert col.counts["procs_retired"] == 0


# ---------------------------------------------------------------------------
# alert rules: threshold / absence lifecycle
# ---------------------------------------------------------------------------

def _mgr(db, rules, events=None):
    return AlertManager(tsdb=db, rules=rules, eval_s=0.0,
                        event_cb=events.append
                        if events is not None else None)


def test_threshold_alert_pending_firing_resolved():
    db = TimeSeriesDB()
    events = []
    mgr = _mgr(db, [AlertRule("hot", "threshold", metric="temp",
                              op=">", value=80.0, for_s=10.0,
                              resolve_s=20.0)], events)
    db.append(T0, [("temp", {}, "gauge", 95.0, None)])
    mgr.evaluate(now=T0)
    assert mgr.active()[0]["state"] == "pending"
    mgr.evaluate(now=T0 + 5)  # for_s not yet served
    assert mgr.active()[0]["state"] == "pending"
    mgr.evaluate(now=T0 + 11)
    assert mgr.active()[0]["state"] == "firing"
    assert _cval("paddle_tpu_alerts_firing") >= 1
    # condition clears; firing holds through resolve_s, then resolves
    db.append(T0 + 20, [("temp", {}, "gauge", 40.0, None)])
    mgr.evaluate(now=T0 + 30)
    assert mgr.active()[0]["state"] == "firing"
    mgr.evaluate(now=T0 + 51)
    assert mgr.active() == []
    st = mgr.state()
    assert st["counts"]["resolved"] == 1
    assert [e["kind"] for e in events] == \
        ["alert_pending", "alert_firing", "alert_resolved"]
    assert st["history"][0]["rule"] == "hot"


def test_threshold_pending_that_never_fires_is_dropped_quietly():
    db = TimeSeriesDB()
    events = []
    mgr = _mgr(db, [AlertRule("hot", "threshold", metric="temp",
                              op=">", value=80.0, for_s=30.0)],
               events)
    db.append(T0, [("temp", {}, "gauge", 95.0, None)])
    mgr.evaluate(now=T0)
    db.append(T0 + 5, [("temp", {}, "gauge", 10.0, None)])
    mgr.evaluate(now=T0 + 5)
    assert mgr.active() == []
    assert [e["kind"] for e in events] == ["alert_pending"]
    assert mgr.state()["counts"]["firing"] == 0


def test_absence_rule_fires_per_silent_proc():
    fleet = {"procs": [
        {"host": "h1", "pid": 1, "role": "worker", "age_s": 99.0},
        {"host": "h2", "pid": 2, "role": "worker", "age_s": 1.0}]}
    mgr = AlertManager(tsdb=None, fleet_fn=lambda: fleet, eval_s=0.0,
                       rules=[AlertRule("gone", "absence",
                                        max_age_s=30.0)])
    mgr.evaluate(now=T0)
    act = mgr.active()
    assert len(act) == 1 and act[0]["state"] == "firing"  # for_s=0
    assert act[0]["labels"]["host"] == "h1"


def test_threshold_group_by_isolates_instances():
    db = TimeSeriesDB()
    for i in range(3):
        db.append(T0 + i, [
            ("errs_total", {"role": "router"}, "counter",
             float(30 * i), None),
            ("errs_total", {"role": "worker"}, "counter", 0.0, None)])
    mgr = _mgr(db, [AlertRule("errs", "threshold",
                              metric="errs_total", op=">",
                              value=10.0, mode="rate", window=2.0,
                              group_by=["role"])])
    mgr.evaluate(now=T0 + 2)
    act = mgr.active()
    assert len(act) == 1
    assert act[0]["labels"] == {"role": "router"}


def test_rules_load_from_json_env(tmp_path, monkeypatch):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps([
        {"name": "r1", "kind": "threshold", "metric": "m", "op": ">",
         "value": 5}]))
    monkeypatch.setenv("PADDLE_TPU_ALERTS_RULES", str(p))
    rules = load_rules()
    assert [r.name for r in rules] == ["r1"]
    # a broken file falls back to the shipped defaults
    p.write_text("{not json")
    names = {r.name for r in load_rules()}
    assert "slo-burn-rate" in names and "tenant-burn-rate" in names


def test_bad_rule_kind_rejected():
    with pytest.raises(ValueError):
        AlertRule("x", "nonsense")
    with pytest.raises(ValueError):
        AlertRule("x", "burn_rate")  # needs bad_metric


# ---------------------------------------------------------------------------
# burn-rate chaos drill (the acceptance loop): seeded traffic + decode
# stall => pending -> firing + bundle; resolves post-recovery; the
# same-seed fault-free baseline never fires
# ---------------------------------------------------------------------------

def _tiny_engine(**kw):
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    cfg = GPTConfig.tiny(num_layers=1)
    model = GPTDecodeModel(cfg, params=init_gpt_params(cfg, seed=0),
                           device="cpu")
    kw.setdefault("num_slots", 4)
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seq_len", 48)
    return Engine(model, **kw)


@pytest.fixture(scope="module")
def drill_engine():
    eng = _tiny_engine()
    for plen in (2, 4, 8):
        eng.submit(np.full(plen, 1), 2)
    eng.run_until_idle()
    return eng


def _drill_traffic(seed=311, duration=3.0, rate=25):
    return TrafficConfig(
        rate=rate, duration=duration, arrival="constant", seed=seed,
        prompt_lens={2: 2, 4: 2, 8: 1}, output_lens={2: 2, 4: 1},
        tenants={"web": 2, "batch": 1}, tiers={0: 1, 1: 2},
        deadlines={0: 1.0, 1: 1.5}, vocab_size=64)


def _slo_dump(t, gens):
    """The real registry dump, filtered to this drill's SLO series so
    leftover series from other tests cannot leak into the window."""
    dump = _obs.REGISTRY.to_dict()
    keep = []
    for m in dump["metrics"]:
        if m["name"] not in ("paddle_tpu_slo_deadline_missed_total",
                             "paddle_tpu_slo_deadline_met_total"):
            continue
        samples = [s for s in m["samples"]
                   if s["labels"].get("gen") in gens]
        if samples:
            keep.append(dict(m, samples=samples))
    dump["metrics"] = keep
    dump["time"] = t
    return dump


def _drill_collector(events):
    db = TimeSeriesDB()
    rules = [r for r in default_rules() if r.name == "slo-burn-rate"]
    assert rules and rules[0].capture_bundle
    alerts = AlertManager(tsdb=db, rules=rules, eval_s=0.0)
    col = TelemetryCollector(sample=0.0, tsdb=db, alerts=alerts)

    def cb(ev):  # observe transitions AND keep the collector mirror
        events.append(ev)
        col._note_alert_event(ev)

    alerts.event_cb = cb
    return col


def _ingest_slo(col, t, gens):
    col.ingest({"op": "tel_push", "host": "lg", "pid": 1,
                "role": "loadgen", "anchor": 0.0, "offset": 0.0,
                "rtt": 0.001, "wall": time.time(), "spans": [],
                "flight": [], "events": [], "dropped": {},
                "metrics": _slo_dump(t, gens)})


def test_burn_rate_chaos_drill(drill_engine, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DEBUG_DIR", str(tmp_path / "dbg"))
    eng = drill_engine

    # -- baseline: same seed, no fault ---------------------------------
    with eng:
        res_base = LoadGenerator(_drill_traffic(),
                                 name="tsdb_base").run_engine(eng)
        assert res_base.wait(180)
    rep_base = slo_report(res_base)
    assert rep_base["offered"] > 20
    assert rep_base["attainment"] >= 0.9, rep_base

    # -- faulted run: identical traffic, decode stall mid-run ----------
    box = []
    with eng:
        t = threading.Thread(
            target=lambda: box.append(LoadGenerator(
                _drill_traffic(), name="tsdb_fault").run_engine(eng)),
            daemon=True)
        t.start()
        time.sleep(0.5)
        fi.reset_injector(fi.FaultInjector(stall=1.2,
                                           stall_point="serving_decode"))
        time.sleep(2.8)
        fi.reset_injector(fi.FaultInjector())
        t.join(timeout=180)
        assert box and box[0].wait(180)
    slo_report(box[0], gen="tsdb_fault_report")
    missed = _cval("paddle_tpu_slo_deadline_missed_total",
                   gen="tsdb_fault_report")
    met = _cval("paddle_tpu_slo_deadline_met_total",
                gen="tsdb_fault_report")
    # the stall blew enough deadlines to burn >14.4x the 1% budget
    assert missed >= 1
    ratio = missed / max(1.0, missed + met)
    assert ratio > 0.144 * 1.5, (missed, met)

    # -- faulted stream fires the alert + captures a bundle ------------
    events = []
    col = _drill_collector(events)
    _ingest_slo(col, T0, {"tsdb_fault_report"})
    col.alerts.evaluate(now=T0)
    act = col.alerts.active()
    assert act and act[0]["rule"] == "slo-burn-rate"
    assert act[0]["state"] == "pending"
    col.alerts.evaluate(now=T0 + 16)      # for_s=15 served
    act = col.alerts.active()
    assert act[0]["state"] == "firing"
    assert act[0]["value"] >= 14.4
    bundle = act[0]["bundle"]
    assert bundle and os.path.isdir(bundle), \
        "firing SLO alert must capture a debug bundle"
    assert col.alerts.counts["bundles"] == 1
    assert [e["kind"] for e in events] == \
        ["alert_pending", "alert_firing"]
    assert events[1]["attrs"]["bundle"] == bundle
    # the collector mirrors lifecycle into its fleet events feed
    assert any(e["kind"] == "alert_firing"
               for e in col.fleet()["recent_events"])

    # -- recovery: fault-free traffic, same seed, new window -----------
    with eng:
        res_rec = LoadGenerator(_drill_traffic(),
                                name="tsdb_rec").run_engine(eng)
        assert res_rec.wait(180)
    slo_report(res_rec, gen="tsdb_rec_report")
    # the next push carries both series: the faulted counter is flat
    # (cumulative, unchanged), so the 5m window's burn drops to zero
    _ingest_slo(col, T0 + 400,
                {"tsdb_fault_report", "tsdb_rec_report"})
    col.alerts.evaluate(now=T0 + 100)
    assert col.alerts.active()[0]["state"] == "firing"  # resolve_s
    col.alerts.evaluate(now=T0 + 161)
    assert col.alerts.active() == []
    assert col.alerts.counts["resolved"] == 1
    assert [e["kind"] for e in events] == \
        ["alert_pending", "alert_firing", "alert_resolved"]

    # -- baseline stream through an identical pipeline: always quiet --
    b_events = []
    col_b = _drill_collector(b_events)
    _ingest_slo(col_b, T0, {"tsdb_base"})
    for dt in (0, 16, 100, 400):
        col_b.alerts.evaluate(now=T0 + dt)
    _ingest_slo(col_b, T0 + 400, {"tsdb_base"})
    for dt in (401, 500):
        col_b.alerts.evaluate(now=T0 + dt)
    assert col_b.alerts.active() == []
    assert col_b.alerts.counts["pending"] == 0
    assert b_events == []


# ---------------------------------------------------------------------------
# per-tenant metering: engine parity + fleet aggregation
# ---------------------------------------------------------------------------

def test_meter_parity_with_engine(drill_engine):
    eng = drill_engine
    base = meter_mod.METER.report()["tenants"]

    def snap(key, field):
        slot = base.get(key, {})
        if field == "outcomes":
            return dict(slot.get("outcomes", {}))
        return slot.get(field, 0.0)

    with eng:
        handles = []
        for i in range(6):
            handles.append(eng.submit(
                np.full(4, 1 + i % 3), 4, tenant=f"t{i % 2}",
                priority=1))
        eng.run_until_idle()
    rep = meter_mod.METER.report()["tenants"]
    for tn in ("t0", "t1"):
        key = f"{tn}/1"
        assert rep[key]["tokens_in"] - snap(key, "tokens_in") == 12
        done = rep[key]["outcomes"].get("completed", 0) \
            - snap(key, "outcomes").get("completed", 0)
        assert done == 3
        gen_tokens = sum(len(h.generated) for h in handles
                         if h.tenant == tn)
        assert rep[key].get("tokens_out", 0) \
            - snap(key, "tokens_out") == gen_tokens
        assert rep[key].get("kv_page_seconds", 0) \
            > snap(key, "kv_page_seconds")
        assert rep[key].get("flops", 0) > snap(key, "flops")


def test_usage_report_fleet_scope_sums_processes():
    db = TimeSeriesDB()
    for host in ("h1", "h2"):
        db.append(T0, [
            ("paddle_tpu_tenant_tokens_out_total",
             {"host": host, "tenant": "web", "tier": "1"},
             "counter", 10.0, None),
            ("paddle_tpu_tenant_requests_total",
             {"host": host, "tenant": "web", "tier": "1",
              "outcome": "completed"}, "counter", 2.0, None)])
    db.append(T0 + 100, [
        ("paddle_tpu_tenant_tokens_out_total",
         {"host": "h1", "tenant": "web", "tier": "1"},
         "counter", 50.0, None)])
    rep = usage_report(db, window=60.0)
    assert rep["scope"] == "fleet"
    web = rep["tenants"]["web/1"]
    assert web["tokens_out"] == 60.0          # summed across hosts
    assert web["tokens_out_window"] == 40.0   # only h1 moved lately
    assert web["outcomes"] == {"completed": 4.0}
    # process scope (no TSDB) reads the local meter
    assert usage_report(None)["scope"] == "process"


def test_tenant_interning_caps_cardinality():
    m = UsageMeter(cap=2)
    o0 = _cval("paddle_tpu_tenant_overflow_total")
    assert m.intern("a") == "a"
    assert m.intern("b") == "b"
    assert m.intern("a") == "a"          # known stays itself
    assert m.intern("c") == "~other"     # over cap -> overflow bucket
    assert m.intern("d") == "~other"
    assert m.intern("c") == "~other"     # counted once per tenant
    assert _cval("paddle_tpu_tenant_overflow_total") - o0 == 2
    assert m.intern(None) == "default" or m.intern(None) == "~other"


def test_outcome_vocabulary_is_closed():
    from paddle_tpu_torch.observability.meter import (OUTCOMES,
                                                normalize_outcome)
    assert normalize_outcome("done") == "completed"
    assert normalize_outcome("queue_full") == "rejected"
    assert normalize_outcome("draining") == "rejected"
    assert normalize_outcome("expired_in_queue") == "expired"
    assert normalize_outcome("deadline") == "preempted"
    assert normalize_outcome("error") == "failed"
    assert normalize_outcome("weird-new-thing") == "other"
    assert all(normalize_outcome(o) in OUTCOMES
               for o in ("done", "shed", "quota", "cancelled", "x"))


# ---------------------------------------------------------------------------
# cross-package: one directory, both packages' queries
# ---------------------------------------------------------------------------

def _mixed_appends(db, n=400):
    """Counters, gauges and a histogram over 400 s of 1 s samples from
    two processes: enough to seal 4 KiB blocks and downsample them."""
    buckets = (0.001, 0.01, 0.1, 1.0)
    for i in range(n):
        t = T0 + i
        ents = [("reqs_total", {"host": "h", "pid": str(p), "role": "w"},
                 "counter", float(i * (p + 2)), None) for p in range(2)]
        ents += [("depth", {"host": "h", "pid": str(p), "role": "w"},
                  "gauge", float((i * 7 + p) % 13), None)
                 for p in range(2)]
        cum = tuple(float(min(i + 1, (b + 1) * (i + 1) // 4 + 1))
                    for b in range(len(buckets) + 1))
        ents.append(("lat_seconds", {"host": "h", "pid": "0",
                                     "role": "w"}, "histogram",
                     (cum, 0.003 * (i + 1), float(cum[-1])), buckets))
        db.append(t, ents)


def _answers(db):
    end = T0 + 399
    out = {"series": sorted(s["key"] for s in db.series()),
           "latest": db.latest("reqs_total"),
           "latest_pid1": db.latest("reqs_total", {"pid": "1"}),
           "depth": db.latest("depth"),
           "by": db.latest_by("reqs_total", ("pid",))}
    for w in (30.0, 120.0, 300.0):
        out[f"range{w}"] = db.range("depth", {"pid": "0"}, end - w, end)
        out[f"delta{w}"] = db.delta("reqs_total", w)
        out[f"rate{w}"] = db.rate("reqs_total", w)
        out[f"q50_{w}"] = db.quantile("lat_seconds", 0.5, w)
        out[f"q99_{w}"] = db.quantile("lat_seconds", 0.99, w)
    return out


def _assert_same_answers(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and isinstance(y, float) \
                and (k.startswith("rate") or k.startswith("q")):
            assert y == pytest.approx(x, rel=1e-12, abs=0.0), k
        else:
            assert x == y, k


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_tsdb_directory_answers_the_other_packages_queries(tmp_path,
                                                           writer):
    from paddle_tpu.observability.timeseries import TimeSeriesDB as JTSDB
    classes = {"port": TimeSeriesDB, "ref": JTSDB}
    reader = "ref" if writer == "port" else "port"
    d = str(tmp_path / "tsdb")
    db = classes[writer](dir_=d, block_bytes=4096)
    _mixed_appends(db)
    assert db.counts["sealed"] > 0
    db.close()
    # both packages reopen the writer's directory: identical answers
    # from the replayed (sealed + active) history
    want = classes[writer](dir_=d, block_bytes=4096)
    got = classes[reader](dir_=d, block_bytes=4096)
    try:
        assert got.counts["replayed"] == want.counts["replayed"] > 0
        assert got.counts["torn"] == want.counts["torn"] == 0
        _assert_same_answers(_answers(want), _answers(got))
    finally:
        want.close()
        got.close()


def test_tsdb_block_files_are_the_same_bytes_in_both_packages(tmp_path):
    from paddle_tpu.observability.timeseries import TimeSeriesDB as JTSDB
    dirs = {}
    for name, cls in (("port", TimeSeriesDB), ("ref", JTSDB)):
        dirs[name] = str(tmp_path / name)
        db = cls(dir_=dirs[name], block_bytes=4096,
                 retention_bytes=24 * 1024)
        _mixed_appends(db)
        db.close()
    files = sorted(os.listdir(dirs["port"]))
    assert files == sorted(os.listdir(dirs["ref"]))
    assert any(f.startswith("block-") for f in files)
    for fn in files:
        with open(os.path.join(dirs["port"], fn), "rb") as a, \
                open(os.path.join(dirs["ref"], fn), "rb") as b:
            assert a.read() == b.read(), fn


def test_note_routed_counts_like_the_reference():
    """UsageMeter.note_routed: one router answer a call, by tenant and
    normalised outcome, under the reference's counter name."""
    from paddle_tpu.observability.meter import UsageMeter as JMeter
    from paddle_tpu.observability.registry import REGISTRY as JREG
    name = "paddle_tpu_tenant_router_requests_total"
    calls = [("web", "done"), ("web", "error"), ("batch", "rejected"),
             ("web", "failed"), ("batch", "done"), ("web", "done")]
    deltas = []
    for meter, reg in ((UsageMeter(cap=8), _obs.REGISTRY),
                       (JMeter(cap=8), JREG)):
        m = reg.get(name)
        before = {lv: s.value for lv, s in m._series()}
        for tenant, outcome in calls:
            meter.note_routed(tenant, outcome)
        deltas.append({lv: s.value - before.get(lv, 0.0)
                       for lv, s in m._series()
                       if s.value != before.get(lv, 0.0)})
    assert deltas[0] == deltas[1] == {
        ("web", "completed"): 2.0, ("web", "failed"): 2.0,
        ("batch", "rejected"): 1.0, ("batch", "completed"): 1.0}


# ---------------------------------------------------------------------------
# top panes: sparkline and the renderers, byte for byte the reference's
# ---------------------------------------------------------------------------

def test_sparkline_monotone_and_bounded():
    from paddle_tpu.observability import top as jtop
    from paddle_tpu_torch.observability import top
    s = top.sparkline([0, 1, 2, 3, 4, 5, 6, 7], width=8)
    assert s == "▁▂▃▄▅▆▇█"
    assert top.sparkline([], width=8) == ""
    assert top.sparkline([5.0] * 100, width=10) == "▁" * 10
    assert len(top.sparkline(list(range(1000)), width=48)) == 48
    rng = np.random.RandomState(5)
    for n in (1, 7, 48, 49, 500):
        vals = list(rng.standard_normal(n)) + [None]
        assert top.sparkline(vals, width=48) \
            == jtop.sparkline(vals, width=48)


def test_render_history_alerts_tenants_panes():
    from paddle_tpu_torch.observability import top
    pts = [(T0 + i, float(i)) for i in range(20)]
    out = top.render_history(
        {"points": [{"key": "m{pid=\"1\"}", "labels": {"pid": "1"},
                     "kind": "counter", "points": pts}]},
        "m", window=300)
    assert "m" in out and "▁" in out and "█" in out
    out = top.render_alerts({"alerts": {
        "active": [{"rule": "slo-burn-rate", "state": "firing",
                    "severity": "page", "labels": {},
                    "since": T0, "value": 20.0, "bundle": "/x"}],
        "history": [], "rules": [{"name": "slo-burn-rate",
                                  "kind": "burn_rate",
                                  "severity": "page", "for_s": 15}]}})
    assert "slo-burn-rate" in out and "firing" in out.lower()
    out = top.render_tenants({"usage": {
        "scope": "fleet", "window_s": 300.0,
        "tenants": {"web/1": {"tenant": "web", "tier": "1",
                              "tokens_in": 100, "tokens_out": 40,
                              "queue_seconds": 1.5,
                              "kv_page_seconds": 9.0, "flops": 1e9,
                              "outcomes": {"completed": 7}}}}})
    assert "web" in out and "tok in" in out.lower()
    assert "completed=7" in out


def _pane_replies():
    """(renderer name, args) over reply dicts shaped as the collector's
    verbs return them, the empty and partial states included."""
    proc = {"role": "replica", "host": "h1", "pid": 4242, "age_s": 1.5,
            "dropped": {"spans": 3, "flight": 1},
            "summary": {"rps": 12.5, "ttft_p50": 0.012, "ttft_p99": 0.09,
                        "itl_p50": 0.031, "itl_p99": 0.044,
                        "queue_depth": 3, "page_occupancy": 0.42,
                        "perf": {"mfu": {"engine:e0": 0.012,
                                         "engine:e1": 0.02},
                                 "breakdown": {"engine:e0/device": 0.002,
                                               "engine:e0/host": 0.03,
                                               "executor/device": 0.1},
                                 "compiles_total": 7,
                                 "hbm": {"in_use": 5.5 * 2 ** 30,
                                         "limit": 80 * 2 ** 30},
                                 "kv_cache_bytes": 3 * 2 ** 30},
                        "tier": {"resident_rows": {"warm": 100,
                                                   "cold": 9000},
                                 "resident_bytes": {"warm": 2 ** 20,
                                                    "cold": 2 ** 28},
                                 "hits": {"warm": 50, "cold": 7},
                                 "faults": 7, "demotions": 3,
                                 "pull_p50": 0.001, "pull_p99": 0.02},
                        "prefix": {"hit_ratio": 0.5, "lookups": 10,
                                   "tokens_saved": 120,
                                   "cached_pages": 8, "shared_pages": 2,
                                   "cow_copies": 1, "evicted": 0,
                                   "sampled_requests": 2,
                                   "sampled_tokens": 40}}}
    bare = {"role": "router-with-a-very-long-role-name", "host": "h2",
            "pid": 7, "summary": {"latency_p50": 0.2,
                                  "latency_p99": None}}
    fleet = {"time": T0, "open_traces": 2, "kept_traces": 5,
             "traces": {"assembled": 9, "kept_error": 1, "kept_slow": 2,
                        "kept_sampled": 2, "sampled_out": 4,
                        "evicted": 0},
             "procs": [proc, bare],
             "recent_events": [
                 {"wall": T0 + i, "role": "replica", "host": "h1",
                  "pid": 4242, "kind": "watchdog_stall",
                  "attrs": {"name": "serving.engine.e0",
                            "bundle": f"/dbg/b{i}"}}
                 for i in range(10)]}
    trace = {"trace_id": "ab" * 8, "procs": [("h1", 1, "client"),
                                            ("h1", 2, "router")],
             "verdict": "kept:error", "complete": False, "error": True,
             "watchdog_flagged": True,
             "flight": [{"tier": "serving", "kind": "router_failover"},
                        {"tier": "rpc", "kind": "retry"}],
             "spans": [{"span_id": "a", "parent_id": None, "name": "e2e",
                        "t0": T0, "t1": T0 + 0.5, "role": "client",
                        "host": "h1", "pid": 1},
                       {"span_id": "b", "parent_id": "a",
                        "name": "router.generate", "t0": T0 + 0.01,
                        "t1": T0 + 0.4, "role": "router", "host": "h1",
                        "pid": 2},
                       {"span_id": "c", "parent_id": "b",
                        "name": "frontend.stream", "t0": T0 + 0.02,
                        "t1": T0 + 0.39, "role": "replica", "host": "h1",
                        "pid": 3}]}
    history = {"points": [
        {"key": "m", "labels": {"pid": "1", "role": "replica"},
         "kind": "gauge", "points": [(T0 + i, float(i % 7))
                                     for i in range(100)]},
        {"key": "m2", "labels": {}, "kind": "gauge", "points": []}]}
    alerts = {"alerts": {
        "active": [{"rule": "slo-burn-rate", "state": "firing",
                    "severity": "page", "instance": "tenant=web",
                    "since": T0, "value": 20.0, "bundle": "/x"},
                   {"rule": "queue", "state": "pending",
                    "since": None, "value": None}],
        "history": [{"at": T0 + i, "rule": "queue", "instance": "-",
                     "state": "firing"} for i in range(12)],
        "rules": [{"name": "slo-burn-rate"}, {"name": "queue"}]}}
    usage = {"usage": {"scope": "fleet", "window_s": 300.0, "tenants": {
        "web/1": {"tenant": "web", "tier": "1", "tokens_in": 100,
                  "tokens_out": 40, "queue_seconds": 1.5,
                  "kv_page_seconds": 9.0, "flops": 1e9,
                  "outcomes": {"completed": 7, "failed": 0}},
        "~other/0": {"tenant": "~other", "tier": "0", "tokens_in": 3,
                     "outcomes": {}}}}}
    return [
        ("render_fleet", (fleet,)), ("render_fleet", ({"procs": []},)),
        ("render_perf", (fleet,)), ("render_perf", ({"procs": [bare]},)),
        ("render_tier", (fleet,)), ("render_tier", ({},)),
        ("render_prefix", (fleet,)), ("render_prefix", ({},)),
        ("render_history", (history, "m", 300.0)),
        ("render_history", ({"points": []}, "m", 60.0)),
        ("render_history", ({"error": "no such metric"}, "m", 60.0)),
        ("render_alerts", (alerts,)), ("render_alerts", ({},)),
        ("render_tenants", (usage,)), ("render_tenants", ({},)),
        ("render_waterfall", (trace,)),
        ("render_waterfall", ({"trace_id": "x"},)),
    ]


def test_top_panes_byte_equal_to_the_reference():
    from paddle_tpu.observability import top as jtop
    from paddle_tpu_torch.observability import top
    for name, args in _pane_replies():
        got = getattr(top, name)(*args)
        assert got == getattr(jtop, name)(*args), name
        assert got.encode() == getattr(jtop, name)(*args).encode()
