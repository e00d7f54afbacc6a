"""The port's fleet telemetry plane (paddle_tpu_torch/observability/
agent.py, collector.py, the tracer and flight sinks, the registry CLI's
trace merge) on the CPU: the cases of tests/test_telemetry.py on the
port — span-ring drop accounting, the agent's bounded drop-oldest
queue, credential redaction and reconnect after a collector's death,
cross-process trace assembly with clock alignment, tail sampling, the
Chrome export, the watchdog and bundle fleet events, the PS shard
hosting the tel_* verbs, the launcher's --telemetry / --tsdb-dir, SLO
exemplars, the offline merge, the router hosting the tel_* verbs (and
refusing them unhosted), and the four-process drill (client, router,
replica and PS shard in one waterfall) — less the lock sanitizer re-run
(item 19). Added: the launcher's collector child streamed to by a
child's agent and respawned alone after a kill, with its TSDB history
kept; the same batches assembled alike by both
packages' collectors; a port agent streaming to a JAX-package collector
and the reverse, giving the same waterfall (span offsets within 1e-6 s:
each side adds its own wall-clock anchor). Every wait has a timeout.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu_torch.distributed.fleet.runtime.rpc import RpcClient
from paddle_tpu_torch.observability import agent as tel_agent
from paddle_tpu_torch.observability import collector as tel_collector
from paddle_tpu_torch.observability import flight as _flight
from paddle_tpu_torch.observability import registry as _obs
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.observability import watchdog as wd_mod
from paddle_tpu_torch.observability.collector import (CollectorServer,
                                                TelemetryCollector)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cval(name: str, **labels) -> float:
    """Current value of a (possibly labeled) registry counter/gauge;
    module-level metrics are global, so tests assert on DELTAS."""
    m = _obs.REGISTRY.get(name)
    if m is None:
        return 0.0
    child = m.labels(**labels) if labels else m
    return float(child.value)


def _span(tid: str, name: str = "op", start: float = 0.0,
          end: float = 0.01, attrs: dict | None = None) -> dict:
    d = {"name": name, "trace_id": tid, "span_id": os.urandom(8).hex(),
         "parent_id": None, "start": start, "end": end, "tid": 1}
    if attrs:
        d["attrs"] = attrs
    return d


def _batch(host: str, pid: int, role: str, spans=(), flight=(),
           events=(), anchor: float = 0.0, offset: float = 0.0) -> dict:
    return {"op": "tel_push", "host": host, "pid": pid, "role": role,
            "anchor": anchor, "offset": offset, "rtt": 0.001,
            "wall": time.time(), "spans": list(spans),
            "flight": list(flight), "events": list(events),
            "dropped": {}}


def _push_simple(col: TelemetryCollector, tid: str, dur: float = 0.01,
                 error: bool = False, host: str = "h", pid: int = 1):
    attrs = {"error": "boom"} if error else None
    col.ingest(_batch(host, pid, "worker",
                      spans=[_span(tid, end=dur, attrs=attrs)]))


# ---------------------------------------------------------------------------
# span ring: loss is counted, never silent
# ---------------------------------------------------------------------------

def test_span_ring_drop_counter_and_high_water():
    t = tracing.Tracer(max_spans=4, enabled=True, bridge_profiler=False)
    d0 = _cval("paddle_tpu_trace_dropped_total")
    for i in range(6):
        with t.span(f"s{i}"):
            pass
    assert _cval("paddle_tpu_trace_dropped_total") - d0 == 2
    assert _cval("paddle_tpu_trace_ring_high_water") >= 4
    # the ring kept the NEWEST spans (deque semantics)
    assert [s.name for s in t.spans()] == ["s2", "s3", "s4", "s5"]


def test_tracer_sink_receives_spans_and_swallows_sink_errors():
    t = tracing.Tracer(max_spans=16, enabled=True, bridge_profiler=False)
    got = []
    t.set_sink(got.append)
    with t.span("a") as sp:
        tid = sp.trace_id
    assert [s.name for s in got] == ["a"]
    assert got[0].trace_id == tid
    # a broken sink must never take the traced code path down with it
    t.set_sink(lambda sp: 1 / 0)
    with t.span("b"):
        pass
    assert [s.name for s in t.spans()] == ["a", "b"]
    t.set_sink(None)


# ---------------------------------------------------------------------------
# agent: bounded queue, drop-oldest, redaction, failure accounting
# ---------------------------------------------------------------------------

def test_agent_queue_overload_drops_oldest_and_counts():
    ag = tel_agent.TelemetryAgent("127.0.0.1:1", role="t", queue_max=3)
    d0 = _cval("paddle_tpu_telemetry_agent_dropped_total", kind="event")
    for i in range(10):
        ag.publish_event("e", i=i)
    with ag._qlock:
        items = list(ag._q)
    assert len(items) == 3
    # oldest went first: the survivors are the newest three
    assert [it[1]["attrs"]["i"] for it in items] == [7, 8, 9]
    assert ag.dropped == {"event": 7}
    assert _cval("paddle_tpu_telemetry_agent_dropped_total",
                 kind="event") - d0 == 7


def test_agent_failed_send_drops_batch_fast_and_counts():
    port = _free_port()     # nothing listening: connect refused
    ag = tel_agent.TelemetryAgent(f"127.0.0.1:{port}", role="t",
                                  queue_max=16)
    for i in range(3):
        ag.publish_event("e", i=i)
    t0 = time.monotonic()
    assert ag.flush_once() is False
    assert time.monotonic() - t0 < 10.0   # single attempt, no storm
    assert ag.send_errors == 1
    assert ag.dropped.get("send") == 3
    with ag._qlock:
        assert len(ag._q) == 0            # batch discarded, not retried


def test_agent_redacts_credential_attrs():
    ag = tel_agent.TelemetryAgent("127.0.0.1:1", role="t", queue_max=8)
    ag.publish_event("cfg", api_key="k", AUTH_TOKEN="t", note="fine")
    with ag._qlock:
        (_, ev), = list(ag._q)
    assert ev["attrs"]["api_key"] == "<redacted>"
    assert ev["attrs"]["AUTH_TOKEN"] == "<redacted>"
    assert ev["attrs"]["note"] == "fine"
    # the span serializer applies the same contract
    t = tracing.Tracer(max_spans=4, enabled=True, bridge_profiler=False)
    with t.span("s", password="hunter2", op="x"):
        pass
    d = tel_agent._span_dict(t.spans()[-1])
    assert d["attrs"]["password"] == "<redacted>"
    assert d["attrs"]["op"] == "x"


def test_maybe_start_from_env_blank_is_disabled(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_COLLECTOR", "   ")
    assert tel_agent.get_agent() is None
    tel_agent.maybe_start_from_env()
    assert tel_agent.get_agent() is None


# ---------------------------------------------------------------------------
# collector: assembly + clock alignment
# ---------------------------------------------------------------------------

def test_collector_assembles_one_waterfall_across_processes():
    """Four processes, four different monotonic anchors and skew
    offsets, one trace id -> ONE waterfall on one aligned clock."""
    col = TelemetryCollector(sample=1.0, linger_s=30.0)
    tid = "00ab" * 4
    procs = [
        ("hostA", 10, "client", 1000.0, 0.0,
         [("e2e.request", 10.0, 10.5)]),
        ("hostA", 11, "router", 2000.0, 0.003,
         [("rpc.server.generate", 10.1, 10.4)]),
        ("hostB", 12, "replica", 50.0, -0.002,
         [("frontend.generate", 10.15, 10.38),
          ("engine.prefill", 10.2, 10.3)]),
        ("hostB", 13, "ps", 7.0, 0.001,
         [("rpc.server.pull", 10.35, 10.38)]),
    ]
    for host, pid, role, anchor, offset, spans in procs:
        col.ingest(_batch(
            host, pid, role, anchor=anchor, offset=offset,
            spans=[_span(tid, name=n,
                         start=w0 - anchor - offset,
                         end=w1 - anchor - offset)
                   for n, w0, w1 in spans]))
    assert col.sweep(force=True) == 1
    tr = col.trace(tid)
    assert tr is not None and tr["complete"]
    assert len(tr["procs"]) == 4
    t0s = [s["t0"] for s in tr["spans"]]
    assert t0s == sorted(t0s)
    assert abs(t0s[0] - 10.0) < 1e-6
    assert abs(tr["duration_ms"] - 500.0) < 1e-3
    names = [s["name"] for s in tr["spans"]]
    assert names == ["e2e.request", "rpc.server.generate",
                     "frontend.generate", "engine.prefill",
                     "rpc.server.pull"]
    # the dashboard waterfall and the merged Chrome export both carry
    # every rank
    from paddle_tpu_torch.observability import top
    text = top.render_waterfall(tr)
    for n in names:
        assert n in text
    doc = col.chrome_trace(tid)
    meta = [e for e in doc["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "process_name"]
    assert len(meta) == 4
    assert {e["pid"] for e in doc["traceEvents"]
            if e.get("ph") == "X"} == {1, 2, 3, 4}


# ---------------------------------------------------------------------------
# tail-based sampling
# ---------------------------------------------------------------------------

def test_tail_sampling_keeps_errors_drops_boring():
    col = TelemetryCollector(sample=0.0, linger_s=30.0)
    _push_simple(col, "deadbeef00000001", error=True)
    _push_simple(col, "deadbeef00000002")
    col.sweep(force=True)
    tr = col.trace("deadbeef00000001")
    assert tr and tr["verdict"] == "kept_error" and tr["error"]
    assert col.trace("deadbeef00000002") is None
    assert col.counts["sampled_out"] == 1
    assert col.counts["kept_error"] == 1


def test_tail_sampling_keeps_deadline_missed_trace():
    col = TelemetryCollector(sample=0.0, linger_s=30.0)
    tid = "feed000000000001"
    _push_simple(col, tid)
    col.ingest(_batch("h", 1, "worker", flight=[{
        "trace_id": tid, "tier": "serving", "kind": "evict",
        "attrs": {"reason": "deadline"}}]))
    col.sweep(force=True)
    tr = col.trace(tid)
    assert tr and tr["verdict"] == "kept_error"
    assert tr["flight"][0]["attrs"]["reason"] == "deadline"


def test_watchdog_event_flags_open_traces():
    col = TelemetryCollector(sample=0.0, linger_s=30.0)
    tid = "0fad000000000001"
    _push_simple(col, tid, host="h", pid=9)
    col.ingest(_batch("h", 9, "worker", events=[{
        "kind": "watchdog_stall", "wall": time.time(),
        "attrs": {"token": "engine.decode"}}]))
    col.sweep(force=True)
    tr = col.trace(tid)
    assert tr and tr["verdict"] == "kept_error"
    assert tr["watchdog_flagged"]
    fl = col.fleet()
    assert any(e["kind"] == "watchdog_stall"
               for e in fl["recent_events"])


def test_tail_sampling_keeps_slow_above_moving_p99():
    col = TelemetryCollector(sample=0.0, linger_s=30.0)
    # warm the duration reservoir past its 32-sample floor with fast,
    # slightly varied traces (hash-sampled out, but still measured)
    for i in range(40):
        _push_simple(col, f"{i:016x}", dur=0.001 + 0.0001 * (i % 5))
        col.sweep(force=True)
    assert col.stats()["p99_threshold_s"] is not None
    slow = "5105105105105105"
    _push_simple(col, slow, dur=0.5)
    col.sweep(force=True)
    tr = col.trace(slow)
    assert tr and tr["verdict"] == "kept_slow"
    assert col.counts["sampled_out"] >= 32


def test_sampling_hash_deterministic_across_collectors():
    keep_tid = "0000000000000001"   # hash bucket 0 -> kept at any rate
    drop_tid = "ffffffffffffffff"   # bucket 710655 -> out at 0.5
    for _ in range(2):
        col = TelemetryCollector(sample=0.5, linger_s=30.0)
        _push_simple(col, keep_tid)
        _push_simple(col, drop_tid)
        col.sweep(force=True)
        assert col.trace(keep_tid)["verdict"] == "kept_sampled"
        assert col.trace(drop_tid) is None


def test_retention_ring_bounded_eviction_counted():
    col = TelemetryCollector(sample=0.0, ring_max=2, linger_s=30.0)
    e0 = _cval("paddle_tpu_telemetry_trace_evicted_total")
    tids = [f"ec{i:014x}" for i in range(3)]
    for tid in tids:
        _push_simple(col, tid, error=True)
    col.sweep(force=True)
    assert col.counts["evicted"] == 1
    assert col.trace(tids[0]) is None          # oldest evicted
    assert col.trace(tids[2]) is not None
    assert _cval("paddle_tpu_telemetry_trace_evicted_total") - e0 == 1


def test_tel_watch_streams_fleet_frames():
    col = TelemetryCollector(sample=0.0, linger_s=30.0)
    gen = tel_collector.telemetry_dispatch(
        col, {"op": "tel_watch"}, keepalive=0.1)
    first = next(gen)
    assert first["subscribed"] and "procs" in first["fleet"]
    assert "fleet" in next(gen)
    gen.close()


# ---------------------------------------------------------------------------
# agent <-> collector over the wire
# ---------------------------------------------------------------------------

def test_agent_streams_spans_and_flight_to_collector():
    col = TelemetryCollector(sample=1.0, linger_s=30.0)
    with CollectorServer(collector=col) as srv:
        ag = tel_agent.TelemetryAgent(srv.endpoint, role="unit",
                                      flush_s=5.0)
        ag.start()
        try:
            with tracing.span("unit.request") as root:
                tid = root.trace_id
                with tracing.span("unit.child"):
                    time.sleep(0.002)
            _flight.record("serving", "submit", trace_id=tid, request=1)
            assert ag.flush_once()
        finally:
            ag.stop()
        col.sweep(force=True)
        tr = col.trace(tid)
        assert tr and tr["complete"]
        assert {"unit.request", "unit.child"} <= \
            {s["name"] for s in tr["spans"]}
        assert any(ev["kind"] == "submit" for ev in tr["flight"])
        # clock sync ran: the fleet row knows this process's ping RTT
        fl = col.fleet()
        row = next(p for p in fl["procs"] if p["role"] == "unit")
        assert row["rtt"] is not None


def test_collector_death_agent_drops_then_reconnects():
    col = TelemetryCollector(sample=1.0, linger_s=30.0)
    srv = CollectorServer(collector=col).start()
    ep = srv.endpoint
    ag = tel_agent.TelemetryAgent(ep, role="unit", queue_max=64)
    try:
        ag.publish_event("before")
        assert ag.flush_once()
        srv.stop()
        # a dead collector PROCESS takes its accepted sockets with it;
        # in-proc the handler thread outlives stop(), so drop the
        # pooled conn to model the death faithfully
        ag._drop_conn()
        # dead collector: enqueue stays instant, the flush fails fast,
        # the batch is dropped and counted — serving never blocks
        ag.publish_event("during")
        t0 = time.monotonic()
        assert ag.flush_once() is False
        assert time.monotonic() - t0 < 10.0
        assert ag.send_errors >= 1
        assert ag.dropped.get("send", 0) >= 1
        # collector respawns on the SAME endpoint; next flush reconnects
        srv = CollectorServer(endpoint=ep, collector=col).start()
        ag.publish_event("after")
        assert ag.flush_once()
    finally:
        ag.stop()
        srv.stop()
    kinds = {e["kind"] for e in col._recent_events}
    assert "before" in kinds and "after" in kinds
    assert "during" not in kinds      # dropped, visibly


def test_watchdog_stall_and_bundle_publish_fleet_events(tmp_path):
    col = TelemetryCollector(sample=1.0, linger_s=30.0)
    with CollectorServer(collector=col) as srv:
        ag = tel_agent.arm(srv.endpoint, role="unit", flush_s=60.0)
        try:
            wd = wd_mod.Watchdog(debug_dir=str(tmp_path), sigterm=False)
            wd.watch("unit.token", lambda: 7, deadline=0.01)
            wd.check_once()           # baseline: probe seen once
            time.sleep(0.05)
            assert wd.check_once() == ["unit.token"]
            assert ag.flush_once()
        finally:
            tel_agent.disarm()
    kinds = [e["kind"] for e in col._recent_events]
    assert "watchdog_stall" in kinds
    assert "bundle" in kinds          # the stall's dump announces itself
    stall = next(e for e in col._recent_events
                 if e["kind"] == "watchdog_stall")
    assert stall["attrs"]["name"] == "unit.token"
    assert stall["attrs"]["bundle"]   # dashboard links straight to it


# ---------------------------------------------------------------------------
# hosting: the router and a PS shard answer tel_* like debug_dump
# ---------------------------------------------------------------------------

def test_router_hosts_telemetry_verbs():
    from paddle_tpu_torch.serving import Router
    r = Router("127.0.0.1:0", replicas=(), telemetry_host=True,
               ping_interval=3600.0)
    r.start()
    try:
        cli = RpcClient(r.endpoint)
        assert "t_collector" in cli.call({"op": "tel_ping"})
        cli.call(_batch("h", 5, "worker", spans=[_span("ab" * 8)]))
        fl = cli.call({"op": "tel_fleet"})["fleet"]
        assert any(p["pid"] == 5 for p in fl["procs"])
        cli.close()
    finally:
        r.stop()


def test_router_without_hosting_rejects_telemetry_verbs():
    from paddle_tpu_torch.serving import Router
    r = Router("127.0.0.1:0", replicas=(), telemetry_host=False,
               ping_interval=3600.0)
    r.start()
    try:
        cli = RpcClient(r.endpoint)
        with pytest.raises(Exception, match="not hosted"):
            cli.call({"op": "tel_ping"})
        cli.close()
    finally:
        r.stop()


def test_ps_shard_hosts_telemetry_verbs(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_HOST", "1")
    from paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime \
        import PSServer
    srv = PSServer("127.0.0.1:0")
    srv.serve_in_thread()
    try:
        cli = RpcClient(srv.endpoint)
        assert "t_collector" in cli.call({"op": "tel_ping"})
        cli.call(_batch("h", 6, "worker", spans=[_span("cd" * 8)]))
        fl = cli.call({"op": "tel_fleet"})["fleet"]
        assert any(p["pid"] == 6 for p in fl["procs"])
        cli.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_launch_telemetry_flag_parses():
    from paddle_tpu_torch.distributed import launch as launch_mod
    # bare flag (terminated by --) picks the documented default
    args = launch_mod._parse(["--telemetry", "--", "train.py"])
    assert args.telemetry == "127.0.0.1:8600"
    args = launch_mod._parse(["--telemetry", "10.0.0.1:9000",
                              "train.py"])
    assert args.telemetry == "10.0.0.1:9000"
    assert launch_mod._parse(["train.py"]).telemetry is None
    args = launch_mod._parse(["--telemetry", "10.0.0.1:9000",
                              "--tsdb-dir", "hist", "train.py"])
    assert args.tsdb_dir == "hist"


# ---------------------------------------------------------------------------
# SLO exemplars: the p99 number links to the trace that IS the p99
# ---------------------------------------------------------------------------

def test_histogram_exemplar_trace_ids_exposed():
    h = _obs.histogram("paddle_tpu_test_exemplar_seconds",
                       "exemplar unit test", buckets=(0.1, 1.0))
    h.observe(0.05, trace_id="abc123")
    h.observe(0.5)                    # no exemplar for this bucket
    assert h.exemplars()[0]["trace_id"] == "abc123"
    dump = _obs.to_dict()
    m = next(x for x in dump["metrics"]
             if x["name"] == "paddle_tpu_test_exemplar_seconds")
    assert m["samples"][0]["exemplars"]["0"]["trace_id"] == "abc123"


def test_slo_report_carries_p99_exemplar_trace_ids():
    from paddle_tpu_torch.serving import loadgen

    class FakeHandle:
        def __init__(self, tt, tid):
            self.status = "done"
            self.generated = [1, 2]
            self.deadline = None
            self.finished_at = 1.0
            self.trace_id = tid
            self._tt = tt

        def ttft(self):
            return self._tt

        def inter_token(self):
            return self._tt / 10.0

    res = loadgen.LoadResult("unit", 0.0, 1.0)
    for i in range(10):
        arr = loadgen.Arrival(i, 0.0, [1], 4, "t", 0, None)
        res.handles.append((arr, FakeHandle(0.01 * (i + 1), f"tid{i}")))
    rep = loadgen.slo_report(res, gen="unit_exemplar")
    assert rep["ttft_p99_trace"] == "tid9"
    assert rep["itl_p99_trace"] == "tid9"
    # and the mirrored histogram bucket carries it too
    ex = loadgen._TTFT_H.labels(gen="unit_exemplar").exemplars()
    assert any(e["trace_id"] == "tid9" for e in ex.values())


# ---------------------------------------------------------------------------
# offline merge: the registry CLI shares the collector's merge code
# ---------------------------------------------------------------------------

def test_registry_cli_merges_trace_rings_subprocess(tmp_path):
    for rank, (host, pid) in enumerate([("a", 1), ("b", 2)]):
        doc = {"traceEvents": [{"name": f"s{rank}", "ph": "X", "ts": 0,
                                "dur": 5, "pid": 999, "tid": 1,
                                "args": {}}]}
        (tmp_path / f"trace_{host}_{pid}.json").write_text(
            json.dumps(doc))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.observability.registry",
         str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    agg = json.loads(res.stdout)
    assert agg["trace_merged"]["ranks"] == 2
    merged = json.loads((tmp_path / "trace_merged.json").read_text())
    evs = merged["traceEvents"]
    meta = [e for e in evs
            if e.get("ph") == "M" and e["name"] == "process_name"]
    assert len(meta) == 2
    # re-pidded dense per rank, not the colliding raw 999s
    assert {e["pid"] for e in evs if e.get("ph") == "X"} == {1, 2}


def test_aggregate_dir_sums_per_process_dumps(tmp_path):
    """registry.aggregate_dir: the metrics_*.json dumps of a job's
    processes merge (counters sum), as the JAX package's do."""
    from paddle_tpu.observability import registry as j_obs
    for pid, v in ((1, 2.0), (2, 5.0)):
        reg = _obs.MetricsRegistry()
        reg.counter("paddle_tpu_aggtest_total", "t").inc(v)
        reg.dump_to_file(str(tmp_path / f"metrics_h_{pid}.json"))
    (tmp_path / "other.json").write_text("{}")
    agg = _obs.aggregate_dir(str(tmp_path))
    m = next(x for x in agg["metrics"]
             if x["name"] == "paddle_tpu_aggtest_total")
    assert agg["aggregated_from"] == 2
    assert m["samples"][0]["value"] == 7.0
    ref = j_obs.aggregate_dir(str(tmp_path))
    assert [x for x in ref["metrics"]
            if x["name"] == "paddle_tpu_aggtest_total"] == [m]


# ---------------------------------------------------------------------------
# the launcher's collector child
# ---------------------------------------------------------------------------

_TEL_TRAINER = """
import os, sys, time
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import agent
assert agent.get_agent() is not None, "agent not armed from the env"
c = obs.counter("paddle_tpu_launchtel_units_total", "u")
stop = sys.argv[1]
while not os.path.exists(stop):
    c.inc()
    with obs.span("launchtel.step"):
        time.sleep(0.05)
print("trainer done", flush=True)
"""


def _tel_call(ep, req, timeout=5.0):
    cli = RpcClient(ep, timeout=timeout, deadline=timeout, max_retries=0)
    try:
        return cli.call(req, timeout=timeout, deadline=timeout)
    finally:
        cli.close()


def _wait(pred, timeout=60.0, every=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if pred():
                return True
        except Exception:
            pass
        time.sleep(every)
    return False


def test_launch_telemetry_child_streams_and_respawns_alone(tmp_path):
    """--telemetry E --tsdb-dir D --max_restarts 1: the launcher runs a
    collector child on E; the trainer's agent (armed at import from the
    env) streams to it under its launcher name; killing the collector
    respawns it alone (the trainer runs on, the agent reconnects), and
    the respawned collector answers history recorded before the kill
    from D. The job ends 0 when the trainer finishes."""
    import signal
    ep = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "tel_trainer.py"
    script.write_text(_TEL_TRAINER)
    stop = tmp_path / "stop"
    logs, tsdb = tmp_path / "logs", tmp_path / "tsdb"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PADDLE_TPU_TELEMETRY_FLUSH"] = "0.1"
    for k in ("PADDLE_TPU_TELEMETRY_COLLECTOR", "PADDLE_TPU_TELEMETRY_ROLE",
              "PADDLE_TPU_TELEMETRY_HOST", "PADDLE_TPU_TSDB_DIR"):
        env.pop(k, None)
    launcher = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=1", f"--started_port={_free_port()}",
         "--max_restarts", "1", "--telemetry", ep, "--tsdb-dir",
         str(tsdb), "--log_dir", str(logs), str(script), str(stop)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def roles():
        fl = _tel_call(ep, {"op": "tel_fleet"})["fleet"]
        return {p["role"] for p in fl["procs"]}

    def history():
        return _tel_call(ep, {"op": "tsdb_query", "query": "latest",
                              "metric": "paddle_tpu_launchtel_units_total"}
                         ).get("value")

    def collector_pid():
        for line in (logs / "telemetry.log").read_text().splitlines():
            if line.startswith("{") and '"ready"' in line:
                pid = json.loads(line)["pid"]
        return pid

    try:
        assert _wait(lambda: "trainer.0" in roles()), "agent never seen"
        assert _wait(lambda: (history() or 0) > 0), "no TSDB history"
        before = history()
        pid = collector_pid()
        os.kill(pid, signal.SIGKILL)
        assert _wait(lambda: collector_pid() != pid), "no respawn"
        # durable history answered by the NEW collector process
        assert _wait(lambda: (history() or 0) >= before)
        assert _wait(lambda: "trainer.0" in roles()), "no reconnect"
        stop.write_text("")
        out, err = launcher.communicate(timeout=60)
    finally:
        stop.write_text("")
        if launcher.poll() is None:
            launcher.kill()
            launcher.communicate(timeout=30)
    assert launcher.returncode == 0, err
    assert "telemetry exited with code -9; restarting the stateless " \
        "collector alone" in err, err
    assert "elastic restart" not in err
    assert "trainer done" in (logs / "trainer.0.log").read_text()


# ---------------------------------------------------------------------------
# cross-package: the same assembly, the same wire
# ---------------------------------------------------------------------------

def _fleet_batches(tid):
    """Four processes' batches of one trace (the assembly case's), plus
    an errored and a plain trace for the sampling verdicts."""
    procs = [
        ("hostA", 10, "client", 1000.0, 0.0,
         [("e2e.request", 10.0, 10.5)]),
        ("hostA", 11, "frontend", 2000.0, 0.003,
         [("rpc.server.generate", 10.1, 10.4)]),
        ("hostB", 12, "engine", 50.0, -0.002,
         [("frontend.generate", 10.15, 10.38),
          ("engine.prefill", 10.2, 10.3)]),
        ("hostB", 13, "ps", 7.0, 0.001,
         [("rpc.server.pull", 10.35, 10.38)]),
    ]
    out = []
    for i, (host, pid, role, anchor, offset, spans) in enumerate(procs):
        out.append(_batch(
            host, pid, role, anchor=anchor, offset=offset,
            spans=[dict(_span(tid, name=n, start=w0 - anchor - offset,
                              end=w1 - anchor - offset),
                        span_id=f"{i:04x}{j:012x}")
                   for j, (n, w0, w1) in enumerate(spans)]))
    return out


def test_both_collectors_assemble_the_same_batches_alike():
    from paddle_tpu.observability.collector import \
        TelemetryCollector as JCollector
    tid = "00ab" * 4
    tids = [f"{i:016x}" for i in range(1, 40, 3)] + ["ffffffffffffffff"]
    cols = [TelemetryCollector(sample=0.3, linger_s=30.0, alerts=None),
            JCollector(sample=0.3, linger_s=30.0, alerts=None)]
    for col in cols:
        for b in _fleet_batches(tid):
            col.ingest(b)
        for t in tids:
            col.ingest(_batch("h", 1, "worker", spans=[
                dict(_span(t, end=0.01), span_id=t)]))
        col.ingest(_batch("h", 2, "worker", spans=[
            dict(_span("e" * 16, attrs={"error": "x"}),
                 span_id="e" * 16)]))
        col.sweep(force=True)
    mine, ref = cols
    for t in [tid, "e" * 16] + tids:
        a, b = mine.trace(t), ref.trace(t)
        assert (a is None) == (b is None), t
        if a is not None:
            a, b = dict(a), dict(b)
            a["procs"] = [list(p) for p in a["procs"]]
            b["procs"] = [list(p) for p in b["procs"]]
            assert a == b, t
    assert mine.chrome_trace(tid) == ref.chrome_trace(tid)
    for k in ("assembled", "kept_error", "kept_slow", "kept_sampled",
              "sampled_out"):
        assert mine.counts[k] == ref.counts[k], k


def _waterfall(col, tid):
    tr = col.trace(tid)
    assert tr is not None and tr["complete"], tr
    t0 = min(s["t0"] for s in tr["spans"])
    return tr["verdict"], [(s["name"], s["span_id"], s["parent_id"],
                            s["role"], s["t0"] - t0, s["t1"] - s["t0"])
                           for s in tr["spans"]]


def test_agents_stream_to_the_other_packages_collector():
    """A port agent pushes spans to a JAX-package CollectorServer and a
    JAX agent the same spans to the port's, over each other's wire: both
    collectors assemble the same waterfall (names, ids, parents, role,
    order; offsets and durations within 1e-6 s)."""
    from paddle_tpu.observability import agent as j_agent
    from paddle_tpu.observability import tracing as j_tracing
    from paddle_tpu.observability.collector import (
        CollectorServer as JServer, TelemetryCollector as JCollector)
    tid = "c0ffee" + "0" * 10
    base = time.monotonic()
    layout = [("svc.request", "0000000000000001", None, 0.0, 0.050),
              ("svc.prefill", "0000000000000002", "0000000000000001",
               0.004, 0.020),
              ("svc.decode", "0000000000000003", "0000000000000001",
               0.021, 0.049)]

    def spans(cls):
        out = []
        for name, sid, parent, a, b in layout:
            sp = cls(name, tid, sid, parent, base + a, 1, {"op": "x"})
            sp.end = base + b
            out.append(sp)
        return out

    got = {}
    jcol = JCollector(sample=1.0, linger_s=30.0, alerts=None)
    pcol = TelemetryCollector(sample=1.0, linger_s=30.0, alerts=None)
    with JServer(collector=jcol) as jsrv, \
            CollectorServer(collector=pcol) as psrv:
        pag = tel_agent.TelemetryAgent(jsrv.endpoint, role="svc",
                                       queue_max=64)
        jag = j_agent.TelemetryAgent(psrv.endpoint, role="svc",
                                     queue_max=64)
        try:
            for sp in spans(tracing.Span):
                pag._on_span(sp)
            for sp in spans(j_tracing.Span):
                jag._on_span(sp)
            assert pag.flush_once() and jag.flush_once()
        finally:
            pag.stop()
            jag.stop()
        for name, col in (("port->ref", jcol), ("ref->port", pcol)):
            col.sweep(force=True)
            got[name] = _waterfall(col, tid)
    (va, wa), (vb, wb) = got["port->ref"], got["ref->port"]
    assert va == vb == "kept_sampled"
    assert [w[:4] for w in wa] == [w[:4] for w in wb]
    assert [w[0] for w in wa] == ["svc.request", "svc.prefill",
                                  "svc.decode"]
    for x, y in zip(wa, wb):
        assert abs(x[4] - y[4]) < 1e-6 and abs(x[5] - y[5]) < 1e-6


_INHERITED = """
import sys, time
from paddle_tpu_torch.distributed import spawn


def work():
    from paddle_tpu_torch.observability import agent
    assert agent.get_agent() is not None   # armed from the inherited env
    agent.publish_event("child_event")


if __name__ == "__main__":
    from paddle_tpu_torch.observability import agent
    assert agent.get_agent() is not None
    spawn(work, nprocs=2, timeout=60)
    print("spawned and joined", flush=True)
"""


def test_inherited_collector_env_never_holds_a_process_at_exit(tmp_path):
    """PADDLE_TPU_TELEMETRY_COLLECTOR inherited by a job whose collector
    is gone: the parent and its spawned workers arm agents at import,
    and every process still exits promptly with code 0 (the agent's
    sender is a daemon; the workers' os._exit path holds)."""
    script = tmp_path / "inherit.py"
    script.write_text(_INHERITED)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PADDLE_TPU_TELEMETRY_COLLECTOR"] = f"127.0.0.1:{_free_port()}"
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "spawned and joined" in res.stdout
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# the acceptance drill: one trace across four processes
# ---------------------------------------------------------------------------

FLEET_ENGINE_KW = dict(num_slots=4, num_pages=64, page_size=4,
                       max_seq_len=48)


def _ready_line(proc: subprocess.Popen, what: str) -> dict:
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        _, err = proc.communicate(timeout=30)
        pytest.fail(f"{what} died before READY: {err[-2000:]}")
    return json.loads(line)


def test_e2e_fleet_trace_spans_four_processes_subprocess(tmp_path):
    """Client + router + replica + PS shard, each its own process with
    its own clock, one ambient trace id on the wire: the collector
    assembles one waterfall retrievable by that id."""
    from paddle_tpu_torch.distributed.fleet import ps_roles
    from paddle_tpu_torch.distributed.fleet.runtime \
        .parameter_server_runtime import PSClient
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from paddle_tpu_torch.observability import top
    from paddle_tpu_torch.serving import GPTDecodeModel, ServingClient

    root = str(tmp_path / "gpt")
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_heads=2,
                    num_layers=2, max_position_embeddings=128,
                    initializer_range=0.5)
    GPTDecodeModel(cfg, params=init_gpt_params(cfg, seed=0),
                   device="cpu").save_checkpoint(root)
    # a long linger: the trace must not finalize between two agents'
    # flush ticks while a tier's spans are still in flight
    col = TelemetryCollector(sample=1.0, linger_s=3.0)
    srv = CollectorServer(collector=col).start()
    base = dict(os.environ)
    base["PYTHONPATH"] = REPO + os.pathsep + base.get("PYTHONPATH", "")
    base["PADDLE_TPU_TELEMETRY_COLLECTOR"] = srv.endpoint
    base["PADDLE_TPU_TELEMETRY_FLUSH"] = "0.2"
    base.pop("PADDLE_TPU_TELEMETRY_HOST", None)

    def spawn(script, env):
        return subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", script)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    children = []
    scli = ps_cli = None
    try:
        rep = spawn("torch_serving_replica.py", dict(
            base,
            PADDLE_TPU_REPLICA_ENDPOINT=f"127.0.0.1:{_free_port()}",
            REPLICA_CKPT=root,
            REPLICA_ENGINE_KW=json.dumps(FLEET_ENGINE_KW),
            PADDLE_TPU_TELEMETRY_ROLE="replica"))
        children.append(rep)
        ps = subprocess.Popen(
            [sys.executable, "-m", ps_roles.__name__],
            env=dict(base, ROLE="server",
                     MY_ENDPOINT=f"127.0.0.1:{_free_port()}",
                     PADDLE_TPU_TELEMETRY_ROLE="ps"),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        children.append(ps)
        rep_ep = _ready_line(rep, "replica")["endpoint"]
        ps_ep = _ready_line(ps, "ps")["endpoint"]
        rout = spawn("torch_telemetry_router.py", dict(
            base, ROUTER_REPLICAS=json.dumps([["r0", rep_ep]]),
            PADDLE_TPU_TELEMETRY_ROLE="router"))
        children.append(rout)
        router_ep = _ready_line(rout, "router")["endpoint"]
        assert _wait(lambda: _tel_call(router_ep, {"op": "stats"})[
            "healthy_replicas"] >= 1, timeout=90), \
            "router never saw a healthy replica"

        tel_agent.disarm()
        ag = tel_agent.arm(srv.endpoint, role="client", flush_s=0.2)
        scli = ServingClient(router_ep)
        ps_cli = PSClient([ps_ep])
        with tracing.span("e2e.request") as root_span:
            tid = root_span.trace_id
            reply = scli.generate([1, 2, 3], 6, timeout=60,
                                  session="s0")
            vals = ps_cli.pull("emb", 4, np.array([1, 2, 3]))
        assert reply["status"] == "done"
        # the front end's reply carries the id the client started
        assert reply["trace_id"] == tid
        assert vals.shape == (3, 4)
        ag.flush_once()

        # wait until spans of four distinct processes landed
        assert _wait(lambda: len({(p[0], p[1]) for p in
                                  (col.trace(tid) or {}).get("procs", ())})
                     >= 4, timeout=60, every=0.2)
        col.sweep(force=True)
        tr = col.trace(tid)
        assert tr is not None and tr["complete"]
        assert tr["verdict"].startswith("kept")
        procs = {(p[0], p[1]) for p in tr["procs"]}
        roles = {p[2] for p in tr["procs"]}
        assert len(procs) >= 4
        assert {"client", "router", "replica", "ps"} <= roles
        by_role = {}
        for s in tr["spans"]:
            by_role.setdefault(s["role"], set()).add(s["name"])
        # each tier contributed its own layer of the waterfall
        assert "e2e.request" in by_role["client"]
        assert any(n.startswith("rpc.server") for n in by_role["router"])
        assert "router.generate" in by_role["router"]
        assert any(n.startswith(("frontend.", "engine.", "rpc.server"))
                   for n in by_role["replica"])
        assert any(n.startswith("rpc.server") for n in by_role["ps"])
        # aligned clocks: nothing starts visibly before the client root
        root_t0 = min(s["t0"] for s in tr["spans"]
                      if s["name"] == "e2e.request")
        assert all(s["t0"] >= root_t0 - 0.25 for s in tr["spans"])
        # one merged Chrome trace, one labelled track group a process
        doc = col.chrome_trace(tid)
        meta = [e for e in doc["traceEvents"]
                if e.get("ph") == "M" and e["name"] == "process_name"]
        assert len(meta) >= 4
        # and the whole of it over the wire by trace id
        rep2 = _tel_call(srv.endpoint, {"op": "tel_trace",
                                        "trace_id": tid, "chrome": True})
        assert rep2["trace"]["trace_id"] == tid
        assert rep2["chrome"]["traceEvents"]
        fleet = _tel_call(srv.endpoint, {"op": "tel_fleet"})["fleet"]
        assert {"client", "router", "replica", "ps"} <= \
            {p["role"] for p in fleet["procs"]}
        assert "router.generate" in top.render_waterfall(tr)
    finally:
        tel_agent.disarm()
        for c in (scli, ps_cli):
            if c is not None:
                c.close()
        for p in children:
            p.kill()
        for p in children:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        srv.stop()
