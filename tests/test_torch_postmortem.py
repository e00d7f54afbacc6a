"""Flight recorder, stall watchdog and postmortem debug bundles of the
port (paddle_tpu_torch/observability/{flight,watchdog,debug}.py and the
engine's wiring into them) on the CPU, held to the JAX package:

  * the cases of tests/test_debug_postmortem.py that need only the
    watchdog, debug, flight, registry, checkpoint, the fault injector
    and the engine, on the port's tiny GPT;
  * both watchdogs driven through the same fake clock and probe values
    fire, stay quiet and recover on the same passes;
  * a bundle written by either package loads, CRC-verified, with the
    other's ``load_bundle`` (and a corrupted one fails in both).

  * the launcher-heartbeat token (``watch_heartbeats`` over
    distributed.elastic's heartbeat files) and the launcher's
    ``--debug_dir`` / ``--metrics_dir`` flags.

The lock sanitizer's rerun of these cases waits for ROADMAP.md A,
item 19.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.observability import debug as jdebug
from paddle_tpu.observability import watchdog as jwatchdog
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.observability import debug as obs_debug
from paddle_tpu_torch.observability import flight as obs_flight
from paddle_tpu_torch.observability import watchdog as obs_watchdog
from paddle_tpu_torch.observability.debug import (BundleError, list_bundles,
                                                  load_bundle, write_bundle)
from paddle_tpu_torch.observability.flight import FlightRecorder
from paddle_tpu_torch.observability.watchdog import WATCHDOG, Watchdog
from paddle_tpu_torch.serving import Engine, GPTDecodeModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE_FILES = {"metrics.prom", "metrics.json", "trace.json",
                "flight.json", "env.json", "requests.json"}


def _tiny_engine(**kw):
    model = GPTDecodeModel(GPTConfig.tiny(num_layers=1), seed=0,
                           device="cpu")
    kw.setdefault("num_slots", 2)
    kw.setdefault("num_pages", 16)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seq_len", 32)
    return Engine(model, **kw)


def _subprocess_env(tmp_path, **extra):
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), **extra)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_bounded_per_tier_and_counts_drops():
    rec = FlightRecorder(max_events=4, enabled=True)
    for i in range(10):
        rec.record("chatty", "tick", i=i)
    rec.record("sparse", "snapshot", seq=1)
    assert [e.attrs["i"] for e in rec.events("chatty")] == [6, 7, 8, 9]
    assert len(rec.events("sparse")) == 1
    snap = rec.snapshot()
    assert len(snap["tiers"]["chatty"]) == 4
    assert snap["tiers"]["sparse"][0]["kind"] == "snapshot"
    all_ev = rec.events()
    assert all(a.ts <= b.ts for a, b in zip(all_ev, all_ev[1:]))


def test_flight_disabled_records_nothing():
    rec = FlightRecorder(max_events=8, enabled=False)
    assert rec.record("t", "k") is None
    assert rec.events() == [] and rec.snapshot()["tiers"] == {}
    rec.set_enabled(True)
    assert rec.record("t", "k") is not None
    assert len(rec.events("t")) == 1


def test_flight_timeline_keyed_by_trace_id_and_json_safe():
    rec = FlightRecorder(max_events=64, enabled=True)
    rec.record("serving", "submit", trace_id="aa11", request=1)
    rec.record("rpc", "server_request", trace_id="aa11", op="generate")
    rec.record("serving", "submit", trace_id="bb22", request=2)
    rec.record("serving", "weird", trace_id="aa11",
               arr=np.arange(3), scalar=np.int64(7), obj=object())
    assert [e.tier for e in rec.timeline("aa11")] == ["serving", "rpc",
                                                      "serving"]
    parsed = json.loads(json.dumps(rec.snapshot()))
    weird = parsed["tiers"]["serving"][-1]["attrs"]
    assert weird["arr"] == [0, 1, 2] and weird["scalar"] == 7
    assert isinstance(weird["obj"], str)


def test_flight_dump_to_file_is_the_snapshot(tmp_path):
    rec = FlightRecorder(max_events=8, enabled=True)
    rec.record("app", "working", n=3)
    path = rec.dump_to_file(str(tmp_path / "f" / "flight.json"))
    doc = json.load(open(path))
    assert doc["tiers"]["app"][0]["attrs"] == {"n": 3}
    assert not [f for f in os.listdir(tmp_path / "f") if ".tmp" in f]


# ---------------------------------------------------------------------------
# watchdog correctness
# ---------------------------------------------------------------------------

def test_watchdog_slow_but_progressing_never_fires():
    wd = Watchdog(debug_dir=None)
    v = [0]
    wd.watch("slow", probe=lambda: v[0], deadline=0.05)
    for _ in range(10):
        time.sleep(0.02)
        v[0] += 1
        assert wd.check_once() == []
    assert wd.stalled() == []
    wd2 = Watchdog(debug_dir=None)
    wd2.watch("slower", probe=lambda: v[0], deadline=0.01)
    for _ in range(4):
        v[0] += 1
        assert wd2.check_once() == []
        time.sleep(0.03)        # poll gap > deadline, but progress each
        v[0] += 1
    assert wd2.check_once() == [] and wd2.stalled() == []


def test_watchdog_idle_tier_never_fires():
    wd = Watchdog(debug_dir=None)
    wd.watch("idle", probe=lambda: 42, deadline=0.01, idle=lambda: True)
    wd.check_once()
    time.sleep(0.05)
    assert wd.check_once() == [] and wd.stalled() == []


def test_watchdog_fires_once_per_episode_and_recovers(tmp_path):
    fired = []
    wd = Watchdog(debug_dir=str(tmp_path))
    v = [1]
    wd.watch("tok", probe=lambda: v[0], deadline=0.05,
             on_stall=lambda name, age, path: fired.append(
                 (name, age, path)))
    wd.check_once()             # baseline
    time.sleep(0.08)
    assert wd.check_once() == ["tok"]
    assert wd.check_once() == []               # once per episode
    assert wd.stalled() == ["tok"]
    (name, age, path), = fired
    assert name == "tok" and age > 0.05
    b = load_bundle(path)
    assert b["manifest"]["reason"] == "watchdog:tok"
    assert "paddle_tpu_watchdog_stalls_total" in b["files"]["metrics.prom"]
    v[0] += 1
    assert wd.check_once() == [] and wd.stalled() == []
    time.sleep(0.08)
    assert wd.check_once() == ["tok"]
    wd.unwatch("tok")
    assert wd.tokens() == []


def test_watchdog_dead_probe_unregisters():
    wd = Watchdog(debug_dir=None)
    wd.watch("gone", probe=lambda: None, deadline=0.01)
    wd.check_once()
    assert wd.tokens() == []


def test_watchdog_healthy_predicate_fires_after_continuous_unhealth():
    """The predicate form the heartbeat token is built on: healthy
    polls are progress, unhealth past the deadline fires once."""
    now = [0.0]
    wd = Watchdog(debug_dir=None, now=lambda: now[0])
    ok = [True]
    wd.watch("hb", lambda: ok[0], deadline=1.0, healthy=True)
    for t in (0.5, 1.0, 2.0):
        now[0] = t
        assert wd.check_once() == []
    ok[0] = False
    now[0] = 2.5
    assert wd.check_once() == []
    now[0] = 3.5
    assert wd.check_once() == ["hb"] and wd.stalled() == ["hb"]
    ok[0] = True
    now[0] = 3.6
    assert wd.check_once() == [] and wd.stalled() == []


def test_watchdog_healthy_predicate_and_heartbeats(tmp_path):
    from paddle_tpu_torch.distributed.elastic import HeartbeatWriter
    wd = Watchdog(debug_dir=None)
    hb = HeartbeatWriter(str(tmp_path), rank=0, interval=0.05).start()
    try:
        wd.watch_heartbeats(str(tmp_path), timeout=0.5, expected=1,
                            deadline=0.05)
        wd.check_once()
        time.sleep(0.1)
        assert wd.check_once() == []           # beating = healthy
    finally:
        hb.stop()
    time.sleep(0.7)                            # beats go stale
    fired = wd.check_once()
    if not fired:                              # unhealth just started
        time.sleep(0.07)
        fired = wd.check_once()
    assert fired == ["elastic.heartbeats"]


def test_module_level_watch_helpers_match_the_jax_package():
    for name in ("watch", "watch_healthy", "watch_heartbeats", "unwatch",
                 "check_once"):
        assert hasattr(obs_watchdog, name), name
    assert set(jwatchdog.__all__) <= set(obs_watchdog.__all__)


def test_launch_parser_accepts_debug_dir():
    from paddle_tpu_torch.distributed.launch import _parse
    args = _parse(["--debug_dir", "/tmp/x", "--metrics_dir", "/tmp/y",
                   "train.py"])
    assert args.debug_dir == "/tmp/x" and args.metrics_dir == "/tmp/y"
    assert args.training_script == "train.py"


def test_watchdog_deadline_from_env_at_registration(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WATCHDOG_DEADLINE", "0.25")
    assert obs_watchdog.default_deadline() == 0.25
    wd = Watchdog(debug_dir=None)
    wd.watch("t", probe=lambda: 1)
    monkeypatch.setenv("PADDLE_TPU_WATCHDOG_DEADLINE", "9")
    assert wd._tokens["t"].deadline == 0.25     # read when registered
    monkeypatch.setenv("PADDLE_TPU_WATCHDOG_DEADLINE", "junk")
    assert obs_watchdog.default_deadline() == 300.0


def test_watchdog_poll_thread_detects_and_stops():
    wd = Watchdog(interval=0.02, debug_dir=None)
    wd.watch("bg", probe=lambda: 7, deadline=0.05)
    wd.start()
    try:
        t0 = time.monotonic()
        while wd.stalled() != ["bg"] and time.monotonic() - t0 < 5:
            time.sleep(0.01)
        assert wd.stalled() == ["bg"]
    finally:
        wd.stop()
    assert wd._thread is None


# (name, deadline, [(t, probe value, idle)], with healthy=False)
SCENARIOS = {
    "hang_then_progress": (1.0, [(0.0, 1, False), (0.5, 1, False),
                                 (1.2, 1, False), (1.3, 1, False),
                                 (1.4, 2, False), (2.0, 2, False),
                                 (2.6, 2, False)]),
    "idle_resets_the_clock": (1.0, [(0.0, 1, False), (0.9, 1, True),
                                    (1.5, 1, False), (2.4, 1, False),
                                    (2.6, 1, False)]),
    "steady_progress": (0.5, [(0.1 * i, i, False) for i in range(12)]),
    "stall_while_fired_then_idle": (0.3, [(0.0, 5, False),
                                          (0.4, 5, False),
                                          (0.5, 5, True),
                                          (0.6, 5, False),
                                          (1.0, 5, False)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_watchdog_fires_like_the_jax_package(name):
    """The same fake clock, probe values and idle flags through both
    packages' Watchdog: the same tokens fire on the same passes and the
    same stall episodes stand after each."""
    deadline, steps = SCENARIOS[name]
    out = []
    for mod in (jwatchdog, obs_watchdog):
        now = [0.0]
        state = {"v": 0, "idle": False}
        wd = mod.Watchdog(debug_dir=None, now=lambda: now[0])
        wd.watch("tok", probe=lambda: state["v"], deadline=deadline,
                 idle=lambda: state["idle"])
        trace = []
        for t, v, idle in steps:
            now[0], state["v"], state["idle"] = t, v, idle
            trace.append((wd.check_once(), wd.stalled()))
        wd.unwatch("tok")
        out.append(trace)
    assert out[0] == out[1]
    assert any(f for f, _ in out[1]) == (name != "steady_progress")


def test_watchdog_metric_names_match_the_jax_package():
    series = ("_CHECKS", "_STALLS", "_STALLED", "_AGE")
    port = [(getattr(obs_watchdog, m).name, getattr(obs_watchdog, m).kind,
             tuple(getattr(obs_watchdog, m).labelnames)) for m in series]
    ref = [(getattr(jwatchdog, m).name, getattr(jwatchdog, m).kind,
            tuple(getattr(jwatchdog, m).labelnames)) for m in series]
    assert port == ref


# ---------------------------------------------------------------------------
# bundles
# ---------------------------------------------------------------------------

def test_bundle_write_load_roundtrip_and_crc(tmp_path):
    obs_flight.record("test", "bundle_marker", answer=42)
    path = write_bundle(str(tmp_path), reason="unit")
    assert os.path.basename(path).startswith("bundle_")
    b = load_bundle(path)
    assert b["manifest"]["reason"] == "unit"
    assert set(b["files"]) == BUNDLE_FILES
    assert "# TYPE" in b["files"]["metrics.prom"]
    assert "traceEvents" in b["files"]["trace.json"]
    tiers = b["files"]["flight.json"]["tiers"]
    assert any(e["kind"] == "bundle_marker" for e in tiers.get("test", []))
    versions = b["files"]["env.json"]["versions"]
    assert versions["python"] and versions["torch"] and versions["numpy"]
    assert "jax" not in versions and "jaxlib" not in versions
    assert versions["device"] is None          # no card on this host
    with open(os.path.join(path, "flight.json"), "ab") as f:
        f.write(b"x")
    with pytest.raises(BundleError):
        load_bundle(path)
    assert list_bundles(str(tmp_path))[0]["valid"] is False


def test_bundle_commit_is_atomic(tmp_path):
    os.makedirs(tmp_path / ".tmp_bundle_h_1_2_3")
    (tmp_path / ".tmp_bundle_h_1_2_3" / "metrics.prom").write_text("x")
    assert list_bundles(str(tmp_path)) == []


def test_bundle_needs_a_directory(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DEBUG_DIR", raising=False)
    with pytest.raises(ValueError, match="PADDLE_TPU_DEBUG_DIR"):
        write_bundle(None)
    assert obs_debug.try_write_bundle("nowhere") is None


def test_bundle_extra_and_secret_redaction(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_PS_SECRET", "hunter2-do-not-leak")
    monkeypatch.setenv("PADDLE_TPU_SOME_KEY", "k")
    path = write_bundle(str(tmp_path), reason="x", extra={"rank": 3})
    b = load_bundle(path)
    assert b["files"]["extra.json"] == {"rank": 3}
    env = b["files"]["env.json"]["env"]
    assert env["PADDLE_PS_SECRET"] == "<redacted>"
    assert env["PADDLE_TPU_SOME_KEY"] == "<redacted>"
    assert "hunter2" not in json.dumps(b["files"])


def test_aggregator_lists_and_merges_bundles(tmp_path):
    from paddle_tpu_torch.observability.debug import aggregate_with_bundles
    from paddle_tpu_torch.observability.registry import MetricsRegistry
    write_bundle(str(tmp_path), reason="rank0")
    write_bundle(str(tmp_path), reason="rank0-later")
    reg = MetricsRegistry()
    reg.counter("paddle_tpu_t_agg_total", "t").inc(5)
    other = reg.to_dict()
    other["pid"] = 99999
    with open(tmp_path / "metrics_h_99999.json", "w") as f:
        json.dump(other, f)
    agg = aggregate_with_bundles(str(tmp_path))
    assert agg["aggregated_from"] == 2
    assert [b["reason"] for b in agg["bundles"]] == ["rank0",
                                                     "rank0-later"]
    assert all(b["valid"] for b in agg["bundles"])
    by_name = {m["name"]: m for m in agg["metrics"]}
    assert by_name["paddle_tpu_t_agg_total"]["samples"][0]["value"] == 5
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.observability.registry",
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        env=_subprocess_env(tmp_path))
    assert res.returncode == 0, res.stderr
    assert len(json.loads(res.stdout)["bundles"]) == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bundles_load_across_packages(tmp_path, writer):
    """Each package's load_bundle(verify=True) reads the other's bundle:
    the same files, manifest keys and CRCs; a flipped byte fails both."""
    w, r = (obs_debug, jdebug) if writer == "port" else (jdebug, obs_debug)
    path = w.write_bundle(str(tmp_path), reason=f"from-{writer}",
                          extra={"k": [1, 2]})
    mine, theirs = w.load_bundle(path), r.load_bundle(path, verify=True)
    assert theirs["manifest"] == mine["manifest"]
    assert theirs["files"] == mine["files"]
    assert set(theirs["files"]) == BUNDLE_FILES | {"extra.json"}
    assert set(theirs["manifest"]) == {"version", "reason", "host", "pid",
                                       "time", "files"}
    assert theirs["manifest"]["version"] == jdebug.BUNDLE_VERSION \
        == obs_debug.BUNDLE_VERSION
    assert [b["valid"] for b in r.list_bundles(str(tmp_path))] == [True]
    with open(os.path.join(path, "metrics.json"), "r+b") as f:
        f.seek(2)
        c = f.read(1)
        f.seek(2)
        f.write(bytes([c[0] ^ 1]))
    for mod in (obs_debug, jdebug):
        err = mod.BundleError
        with pytest.raises(err, match="crc"):
            mod.load_bundle(path, verify=True)


def test_unhandled_exception_writes_bundle(tmp_path):
    prog = tmp_path / "boom.py"
    prog.write_text(
        "from paddle_tpu_torch import observability as obs\n"
        "obs.flight.record('app', 'about_to_die')\n"
        "raise RuntimeError('boom')\n")
    res = subprocess.run(
        [sys.executable, str(prog)], capture_output=True, text=True,
        timeout=120, env=_subprocess_env(
            tmp_path, PADDLE_TPU_DEBUG_DIR=str(tmp_path / "d")))
    assert res.returncode != 0 and "boom" in res.stderr
    bundles = list_bundles(str(tmp_path / "d"))
    assert len(bundles) == 1 and bundles[0]["valid"]
    assert bundles[0]["reason"] == "excepthook:RuntimeError"
    b = load_bundle(bundles[0]["path"])
    assert any(e["kind"] == "about_to_die"
               for e in b["files"]["flight.json"]["tiers"]["app"])


def test_sigterm_dump_includes_trace_flight_and_bundle(tmp_path):
    prog = tmp_path / "victim.py"
    prog.write_text(
        "import time\n"
        "from paddle_tpu_torch import observability as obs\n"
        "obs.counter('paddle_tpu_sigterm2_units_total', 'u').inc(2)\n"
        "with obs.span('victim.work'):\n"
        "    obs.flight.record('app', 'working')\n"
        "print('READY', flush=True)\n"
        "time.sleep(120)\n")
    proc = subprocess.Popen(
        [sys.executable, str(prog)], stdout=subprocess.PIPE, text=True,
        env=_subprocess_env(tmp_path,
                            PADDLE_TPU_METRICS_DIR=str(tmp_path / "m"),
                            PADDLE_TPU_DEBUG_DIR=str(tmp_path / "d")))
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
    assert rc == -signal.SIGTERM
    mdir = tmp_path / "m"
    files = sorted(os.listdir(mdir))
    assert any(f.startswith("metrics_") for f in files)
    trace = [f for f in files if f.startswith("trace_")]
    flight = [f for f in files if f.startswith("flight_")]
    assert trace and flight
    tr = json.load(open(mdir / trace[0]))
    assert any(e["name"] == "victim.work" for e in tr["traceEvents"])
    fl = json.load(open(mdir / flight[0]))
    assert any(e["kind"] == "working" for e in fl["tiers"]["app"])
    bundles = list_bundles(str(tmp_path / "d"))
    assert len(bundles) == 1 and bundles[0]["valid"]
    assert bundles[0]["reason"] == "sigterm"


# ---------------------------------------------------------------------------
# serving tier: debug_dump verb + the wedged-engine e2e
# ---------------------------------------------------------------------------

def test_engine_registers_token_and_provider_and_drops_them():
    import gc
    eng = _tiny_engine()
    token = f"serving.engine.{eng.engine_id}"
    assert token in WATCHDOG.tokens()
    assert token in obs_debug._requests_snapshot()
    del eng
    gc.collect()
    assert token not in WATCHDOG.tokens()
    assert token not in obs_debug._requests_snapshot()


def test_serving_debug_dump_verb_healthy(tmp_path, monkeypatch):
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    engine = _tiny_engine()
    monkeypatch.setenv("PADDLE_TPU_DEBUG_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_PS_SECRET", "hunter2-do-not-leak")
    with ServingServer(engine, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            rep = cli.generate([1, 2, 3], max_new_tokens=3, timeout=60)
            assert rep["status"] == "done"
            bundle = cli.debug_dump()
        finally:
            cli.close()
    assert bundle["reason"] == "debug_dump"
    for key in ("metrics_text", "metrics", "trace", "flight", "env",
                "requests"):
        assert key in bundle, key
    prov = bundle["requests"][f"serving.engine.{engine.engine_id}"]
    assert prov["inflight"] == []
    assert any(r["status"] == "done" for r in prov["recent"])
    assert bundle["env"]["env"]["PADDLE_PS_SECRET"] == "<redacted>"
    assert "hunter2-do-not-leak" not in json.dumps(bundle["env"])
    disk = load_bundle(bundle["path"])
    assert disk["manifest"]["reason"] == "debug_dump"
    assert disk["files"]["metrics.prom"] == bundle["metrics_text"]
    assert disk["files"]["requests.json"] == \
        json.loads(json.dumps(bundle["requests"]))
    # the JAX package reads the bundle the port's server wrote
    assert jdebug.load_bundle(bundle["path"])["files"] == disk["files"]


def test_prefill_only_traffic_is_progress_not_a_stall(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WATCHDOG_DEADLINE", "0.2")
    eng = _tiny_engine()
    token = f"serving.engine.{eng.engine_id}"
    try:
        eng.start()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.8:
            r = eng.submit([1, 2, 3], max_new_tokens=1)
            assert r.wait(timeout=60)
            assert r.status == "done", r.status
            assert token not in WATCHDOG.check_once()
        assert eng.stats()["steps"] == 0
        assert token not in WATCHDOG.stalled()
    finally:
        eng.stop()


class _WedgedModel:
    """Model wrapper whose decode blocks until released — a wedged step
    on the card, the serving tier's watchdog target."""

    def __init__(self, inner):
        self._inner = inner
        self.release = threading.Event()
        for a in ("params", "max_positions", "device", "cfg"):
            setattr(self, a, getattr(inner, a))

    def init_cache(self, *a, **k):
        return self._inner.init_cache(*a, **k)

    def prefill(self, *a, **k):
        return self._inner.prefill(*a, **k)

    def decode(self, *a, **k):
        self.release.wait()
        return self._inner.decode(*a, **k)


def test_wedged_engine_detected_with_trace_keyed_timeline(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_WATCHDOG_DEADLINE", "0.3")
    inner = GPTDecodeModel(GPTConfig.tiny(num_layers=1), seed=0,
                           device="cpu")
    model = _WedgedModel(inner)
    eng = Engine(model, num_slots=2, num_pages=16, page_size=4,
                 max_seq_len=32)
    token = f"serving.engine.{eng.engine_id}"
    assert token in WATCHDOG.tokens()
    try:
        eng.start()
        req = eng.submit([5, 6, 7], max_new_tokens=8)
        assert req.trace_id
        deadline = time.monotonic() + 60
        while not req.generated and time.monotonic() < deadline:
            time.sleep(0.01)
        assert req.generated, "prefill never completed"
        assert eng.scheduler.active_requests(), "request not running"
        # the step lock is held by the wedged step: stats and drain
        # state must still answer without it
        assert eng.stats()["num_slots"] == 2 and not eng.draining
        WATCHDOG.debug_dir = str(tmp_path)
        try:
            t0 = time.monotonic()
            fired = []
            while not fired and time.monotonic() - t0 < 10:
                fired = [t for t in WATCHDOG.check_once() if t == token]
                time.sleep(0.05)
        finally:
            WATCHDOG.debug_dir = None
        assert fired == [token], "watchdog missed the wedged engine"
        assert time.monotonic() - t0 < 5
        bundles = [r for r in list_bundles(str(tmp_path))
                   if r["reason"] == f"watchdog:{token}"]
        assert bundles and bundles[0]["valid"]
        b = load_bundle(bundles[0]["path"])
        assert "paddle_tpu_watchdog_stalls_total" \
            in b["files"]["metrics.prom"]
        assert isinstance(b["files"]["trace.json"]["traceEvents"], list)
        tiers = b["files"]["flight.json"]["tiers"]
        mine = [e for evs in tiers.values() for e in evs
                if e.get("trace_id") == req.trace_id]
        assert {"submit", "admit", "prefill"} <= {e["kind"] for e in mine}
        assert any(e["kind"] == "stall" and e["attrs"]["token"] == token
                   for e in tiers["watchdog"])
        prov = b["files"]["requests.json"][token]
        stuck = [r for r in prov["inflight"] if r["id"] == req.id]
        assert stuck and stuck[0]["status"] == "running"
        assert stuck[0]["trace_id"] == req.trace_id
        # the JAX package reads the watchdog's bundle too
        assert jdebug.load_bundle(bundles[0]["path"])["manifest"][
            "reason"] == f"watchdog:{token}"
    finally:
        model.release.set()
        eng.stop()
    eng.run_until_idle()
    assert token not in WATCHDOG.check_once()
    assert token not in WATCHDOG.stalled()
