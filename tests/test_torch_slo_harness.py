"""The port's production-traffic harness (paddle_tpu_torch/serving/
loadgen.py) on the CPU, held to the JAX package's:

  * ``schedule()`` gives the reference's arrivals, field for field, for
    three seeds under each of the three arrival processes (and with the
    shared-prefix pool and sampled traffic);
  * ``slo_report`` returns the reference's report on the same synthetic
    LoadResult;
  * the cases of tests/test_slo_harness.py that drive the generator,
    the report and the port's tiny engine, in process and over the
    wire;
  * chaos drill 1: a stall at ``serving_decode`` under generated load is
    detected by the watchdog and the SLO recovers.

  * chaos drill 2: a replica process killed behind the router with a
    stream in flight fails over exactly once, respawns from its
    checkpoint, and same-seed traffic attains within 0.1 of the
    fault-free run after recovery.

The PS-kill drill (test_chaos_ps_kill_under_serving_load) is left out.
"""
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import loadgen as jloadgen
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.observability.watchdog import WATCHDOG
from paddle_tpu_torch.serving import (Engine, GPTDecodeModel, LoadGenerator,
                                      LoadResult, Request, ServingClient,
                                      ServingServer, TrafficConfig,
                                      slo_report)
from paddle_tpu_torch.serving import loadgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


# ---------------------------------------------------------------------------
# schedules: arrival for arrival the reference's
# ---------------------------------------------------------------------------

def _cfg_kw(arrival, seed, **kw):
    base = dict(rate=40, duration=3.0, arrival=arrival, seed=seed,
                diurnal_period=3.0, burst_period=1.0,
                tenants={"web": 3, "batch": 1}, tiers={0: 1, 1: 2, 2: 1},
                deadlines={0: 10.0, 1: 20.0, 2: None}, vocab_size=512)
    base.update(kw)
    return base


def _fields(a):
    return (a.index, a.t, a.prompt.tolist(), a.prompt.dtype.str,
            a.max_new_tokens, a.tenant, a.tier, a.deadline, a.temperature,
            a.top_k, a.top_p, a.seed)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("arrival", ["constant", "diurnal", "bursty"])
def test_schedule_equals_the_jax_package(arrival, seed):
    kw = _cfg_kw(arrival, seed)
    got = LoadGenerator(TrafficConfig(**kw)).schedule()
    want = jloadgen.LoadGenerator(jloadgen.TrafficConfig(**kw)).schedule()
    assert len(got) == len(want) > 20
    assert [_fields(a) for a in got] == [_fields(a) for a in want]


@pytest.mark.parametrize("extra", [
    dict(prefix_pool=4, prefix_len=8, prefix_zipf=1.2),
    dict(temperature=0.8, top_k=40, top_p=0.95),
    dict(prompt_lens={4: 3, 8: 3, 16: 2, 32: 1},
         output_lens={4: 3, 8: 2, 16: 1})])
def test_schedule_equals_the_jax_package_with_options(extra):
    kw = _cfg_kw("diurnal", 7, **extra)
    got = LoadGenerator(TrafficConfig(**kw)).schedule()
    want = jloadgen.LoadGenerator(jloadgen.TrafficConfig(**kw)).schedule()
    assert [_fields(a) for a in got] == [_fields(a) for a in want]


def test_traffic_config_validates_like_the_jax_package():
    for bad in (dict(arrival="poisson"), dict(diurnal_depth=1.0),
                dict(prefix_pool=-1), dict(prefix_zipf=0),
                dict(temperature=-1)):
        for mod in (loadgen, jloadgen):
            with pytest.raises(ValueError):
                mod.TrafficConfig(**bad)
    for arrival in ("constant", "diurnal", "bursty"):
        a = TrafficConfig(rate=10, arrival=arrival)
        b = jloadgen.TrafficConfig(rate=10, arrival=arrival)
        assert a.peak_rate == b.peak_rate
        assert [a.rate_at(t / 10) for t in range(50)] == \
            [b.rate_at(t / 10) for t in range(50)]


def test_schedule_is_deterministic_and_seed_sensitive():
    mk = lambda seed: TrafficConfig(rate=50, duration=2.0,
                                    arrival="diurnal", seed=seed)
    s1 = LoadGenerator(mk(3)).schedule()
    s2 = LoadGenerator(mk(3)).schedule()
    assert len(s1) == len(s2) > 20
    assert [_fields(a) for a in s1] == [_fields(a) for a in s2]
    assert [a.t for a in LoadGenerator(mk(4)).schedule()] != \
        [a.t for a in s1]
    cfg = mk(3)
    assert {a.tier for a in s1} <= set(cfg.tiers)
    assert {a.tenant for a in s1} <= set(cfg.tenants)
    assert all(a.deadline == cfg.deadlines[a.tier] for a in s1)


def test_diurnal_arrivals_modulate_rate():
    cfg = TrafficConfig(rate=60, duration=10.0, arrival="diurnal",
                        diurnal_period=10.0, diurnal_depth=0.8, seed=1)
    sched = LoadGenerator(cfg).schedule()
    peak = sum(1 for a in sched if a.t < 5.0)
    assert peak > 2 * (len(sched) - peak)


def test_bursty_arrivals_concentrate_in_bursts():
    cfg = TrafficConfig(rate=30, duration=8.0, arrival="bursty",
                        burst_period=2.0, burst_fraction=0.25,
                        burst_factor=4.0, seed=2)
    sched = LoadGenerator(cfg).schedule()
    in_burst = sum(1 for a in sched if (a.t % 2.0) / 2.0 < 0.25)
    assert in_burst > len(sched) - in_burst


def test_open_loop_run_never_waits_for_completions():
    gen = LoadGenerator(TrafficConfig(rate=200, duration=0.25, seed=9))

    class _Never:
        def wait(self, t=None):
            return False

    n_sched = len(gen.schedule())
    res = gen.run(lambda arr: _Never())
    assert len(res.handles) == n_sched > 10
    assert res.elapsed < 5.0


def test_run_counts_oversized_arrivals_as_rejected():
    gen = LoadGenerator(TrafficConfig(rate=200, duration=0.2, seed=3))
    n_sched = len(gen.schedule())

    class _H:
        def wait(self, t=None):
            return True

    def submit(arr):
        if arr.max_new_tokens > 2:
            raise ValueError("prompt+max_new_tokens exceeds max_seq_len")
        return _H()

    res = gen.run(submit)
    assert res.offered == n_sched > 5
    assert res.rejected and res.handles


# ---------------------------------------------------------------------------
# the SLO report: the reference's, number for number
# ---------------------------------------------------------------------------

def _handle(status, gen_n=5, sub=0.0, first=0.1, last=0.5, fin=0.5,
            deadline=None, trace="t"):
    r = Request([1], max(gen_n, 1))
    r.status = status
    r._queued_at = sub
    r.submitted_at = sub
    r.first_token_at = first
    r.last_token_at = last
    r.finished_at = fin
    r.generated = [0] * gen_n
    r.deadline = deadline
    r.trace_id = trace
    return r


def _result(mod, name, elapsed, handles, rejected_idx=()):
    sched = mod.LoadGenerator(mod.TrafficConfig(rate=50, duration=2.0,
                                                seed=0)).schedule()
    res = mod.LoadResult(name, 0.0, elapsed)
    res.handles = [(sched[i], h()) for i, h in handles]
    res.rejected = [sched[i] for i in rejected_idx]
    return res


HANDLES = [
    (0, lambda: _handle("done", gen_n=6, trace="a")),
    (1, lambda: _handle("done", gen_n=4, deadline=1.0, fin=0.5,
                        first=0.2, trace="b")),
    (2, lambda: _handle("done", gen_n=8, deadline=0.3, fin=0.5,
                        first=0.05, last=0.9, trace="c")),
    (3, lambda: _handle("deadline", gen_n=2, deadline=0.3, trace="d")),
    (5, lambda: _handle("shed", gen_n=0, first=None, last=None)),
    (8, lambda: _handle("done", gen_n=1, first=0.3, last=0.3,
                        trace="e")),
    (30, lambda: _handle("done", gen_n=12, first=0.02, last=0.4,
                         trace="f")),
    (40, lambda: _handle("error", gen_n=0, first=None, last=None)),
]


@pytest.mark.parametrize("window", [None, (0.0, 0.5), (0.1, float("inf")),
                                    (0.5, 1.5)])
def test_slo_report_equals_the_jax_package(window):
    got = slo_report(_result(loadgen, "p", 2.0, HANDLES, (4, 20)),
                     window=window, gen=f"parity_{window}")
    want = jloadgen.slo_report(_result(jloadgen, "j", 2.0, HANDLES,
                                       (4, 20)),
                               window=window, gen=f"parity_{window}")
    assert got == want
    if window is None:
        assert got["offered"] == 10 and got["met"] == 4
        assert got["by_status"]["rejected"] == 2


def test_slo_report_attainment_goodput_and_percentiles():
    res = _result(loadgen, "t", 2.0, HANDLES[:4], (4,))
    rep = slo_report(res, gen="unit")
    assert rep["offered"] == 5 and rep["met"] == 2
    assert rep["attainment"] == pytest.approx(0.4)
    assert rep["goodput_tokens"] == 10
    assert rep["goodput_tokens_per_sec"] == pytest.approx(5.0)
    assert rep["by_status"] == {"done": 3, "deadline": 1, "rejected": 1}
    att = REGISTRY.get("paddle_tpu_slo_attainment_ratio")
    assert att.labels(gen="unit").value == pytest.approx(0.4)
    met = REGISTRY.get("paddle_tpu_slo_deadline_met_total")
    assert met.labels(gen="unit").value == 2


def test_slo_report_window_rates_use_window_span():
    res = LoadResult("t", 0.0, 8.0)
    sched = LoadGenerator(TrafficConfig(rate=50, duration=8.0,
                                        seed=0)).schedule()
    late = next(a for a in sched if a.t >= 4.0)
    res.handles = [(late, _handle("done", gen_n=400))]
    assert slo_report(res, gen="ws0")["goodput_tokens_per_sec"] == \
        pytest.approx(400 / 8.0)
    tail = slo_report(res, window=(4.0, float("inf")), gen="ws1")
    assert tail["goodput_tokens_per_sec"] == pytest.approx(400 / 4.0)


def test_slo_report_mirrors_metrics_once_per_gen():
    res = LoadResult("once", 0.0, 2.0)
    sched = LoadGenerator(TrafficConfig(rate=50, duration=1.0,
                                        seed=0)).schedule()
    res.handles = [(sched[0], _handle("done", gen_n=5))]
    r1 = slo_report(res)
    r2 = slo_report(res, window=(0.0, float("inf")))
    assert r1["met"] == r2["met"] == 1
    met = REGISTRY.get("paddle_tpu_slo_deadline_met_total")
    good = REGISTRY.get("paddle_tpu_slo_goodput_tokens_total")
    assert met.labels(gen="once").value == 1
    assert good.labels(gen="once").value == 5
    slo_report(res, gen="once_w")
    assert met.labels(gen="once_w").value == 1


def test_custom_gen_series_dropped_with_result():
    sched = LoadGenerator(TrafficConfig(rate=50, duration=1.0,
                                        seed=0)).schedule()
    res = LoadResult("t", 0.0, 1.0)
    res.handles = [(sched[0], _handle("done"))]
    slo_report(res, gen="ephemeral_gen")
    met = REGISTRY.get("paddle_tpu_slo_deadline_met_total")
    assert ("ephemeral_gen",) in dict(met._series())
    del res
    gc.collect()
    assert ("ephemeral_gen",) not in dict(met._series())


def test_percentile_is_nearest_rank_like_the_jax_package():
    cases = [[0.01, 0.9], sorted(float(i) for i in range(1, 11)), [],
             [0.3], sorted(np.random.RandomState(0).rand(37).tolist())]
    for vals in cases:
        for p in (0, 1, 50, 90, 99, 100):
            assert loadgen._pct(vals, p) == jloadgen._pct(vals, p)
            pairs = [(v, f"t{i}") for i, v in enumerate(vals)]
            assert loadgen._pct_exemplar(pairs, p) == \
                jloadgen._pct_exemplar(pairs, p)
    assert loadgen._pct([0.01, 0.9], 50) == 0.01
    assert loadgen._pct([], 50) is None


def test_slo_metric_names_match_the_jax_package():
    series = ("_TTFT_H", "_ITL_H", "_MET", "_MISSED", "_GOODPUT", "_ATTAIN")
    key = lambda m: (m.name, m.kind, tuple(m.labelnames))
    assert [key(getattr(loadgen, s)) for s in series] == \
        [key(getattr(jloadgen, s)) for s in series]


# ---------------------------------------------------------------------------
# engine integration: traffic replay in process and over the wire
# ---------------------------------------------------------------------------

def _tiny_engine(**kw):
    model = GPTDecodeModel(GPTConfig.tiny(num_layers=1), seed=0,
                           device="cpu")
    kw.setdefault("num_slots", 4)
    kw.setdefault("num_pages", 64)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seq_len", 48)
    return Engine(model, **kw)


def _traffic(seed, duration=1.0, rate=40, arrival="bursty"):
    return TrafficConfig(
        rate=rate, duration=duration, arrival=arrival, seed=seed,
        burst_period=0.5, burst_fraction=0.3, burst_factor=3.0,
        prompt_lens={2: 2, 4: 2, 8: 1}, output_lens={2: 2, 4: 1},
        tenants={"web": 2, "batch": 1}, tiers={0: 1, 1: 2, 2: 1},
        deadlines={0: 30.0, 1: 60.0, 2: None}, vocab_size=64)


def _prewarm(eng):
    for plen in (2, 4, 8):
        eng.submit(np.full(plen, 1), 2)
    eng.run_until_idle()


def test_loadgen_drives_engine_to_full_attainment():
    eng = _tiny_engine()
    _prewarm(eng)
    gen = LoadGenerator(_traffic(seed=11), name="e2e")
    with eng:
        res = gen.run_engine(eng)
        assert res.wait(120)
    rep = slo_report(res)
    assert rep["offered"] > 20 and rep["attainment"] == 1.0, rep
    assert rep["goodput_tokens"] > 0
    assert rep["ttft_ms_p99"] >= rep["ttft_ms_p50"] > 0
    st = eng.stats()
    assert st["shed"] == 0 and st["quota_rejected"] == 0
    assert st["pool"]["used_pages"] == 0


def test_loadgen_replays_over_the_wire():
    eng = _tiny_engine()
    _prewarm(eng)
    gen = LoadGenerator(_traffic(seed=21, duration=0.8, rate=25),
                        name="wire")
    with eng, ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            res = gen.run_client(cli, timeout=60)
        finally:
            cli.close()
    rep = slo_report(res)
    assert rep["offered"] > 5 and rep["attainment"] == 1.0, rep
    assert rep["goodput_tokens"] > 0
    assert rep["ttft_ms_p50"] is not None and rep["ttft_ms_p50"] > 0
    assert rep["ttft_ms_p99"] >= rep["ttft_ms_p50"]
    assert rep["itl_ms_p99"] is not None and rep["itl_ms_p99"] > 0
    # every wire handle carries the server's trace id and the tokens
    assert all(h.trace_id and len(h.generated) == a.max_new_tokens
               for a, h in res.handles)


def test_loadgen_one_shot_wire_still_supported():
    eng = _tiny_engine()
    _prewarm(eng)
    gen = LoadGenerator(_traffic(seed=21, duration=0.4, rate=20),
                        name="wire1shot")
    with eng, ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            res = gen.run_client(cli, timeout=60, stream=False)
        finally:
            cli.close()
    rep = slo_report(res)
    assert rep["attainment"] == 1.0, rep
    assert rep["ttft_ms_p50"] is None and rep["itl_ms_p50"] is None


def test_wire_and_in_process_replays_give_the_same_tokens():
    """The same greedy schedule through run_engine and through
    run_client over the wire decodes the same tokens, arrival for
    arrival."""
    eng = _tiny_engine()
    _prewarm(eng)
    cfg = _traffic(seed=5, duration=0.5, rate=20, arrival="constant")
    with eng:
        local = LoadGenerator(cfg, name="local").run_engine(eng)
        assert local.wait(60)
    with eng, ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            wire = LoadGenerator(cfg, name="remote").run_client(cli,
                                                                timeout=60)
        finally:
            cli.close()
    a = {arr.index: [int(t) for t in h.generated] for arr, h in local.handles}
    b = {arr.index: [int(t) for t in h.generated] for arr, h in wire.handles}
    assert a == b and len(a) > 3


def test_frontend_carries_priority_and_tenant_over_the_wire():
    eng = _tiny_engine()
    eng.scheduler.set_tenant_quota("starved", tokens_per_sec=0.001,
                                   burst=1.0)
    with ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            ok = cli.generate([1, 2], 2, tenant="web", priority=0,
                              timeout=60)
            assert ok["status"] == "done"
            rej = cli.generate([1, 2], 2, tenant="starved", timeout=60)
            assert rej["status"] == "rejected"
        finally:
            cli.close()
    assert eng.stats()["quota_rejected"] == 1


# ---------------------------------------------------------------------------
# chaos drill 1: engine stall (PADDLE_PS_FAULT_STALL @ serving_decode)
# ---------------------------------------------------------------------------

def test_chaos_engine_stall_detected_and_slo_recovers(monkeypatch):
    """The fault-free baseline and the faulted run replay IDENTICAL
    traffic (same seed). Mid-run the serving_decode stall wedges the
    step thread inside the step lock; the watchdog fires within its
    deadline while stats/drain-state/ping stay answerable; after the
    knob clears, post-recovery attainment is within 0.1 of the
    baseline's over the same traffic slice."""
    monkeypatch.setenv("PADDLE_TPU_WATCHDOG_DEADLINE", "0.3")
    duration = 3.0
    mk_gen = lambda name: LoadGenerator(
        _traffic(seed=77, duration=duration, rate=25), name=name)

    eng_a = _tiny_engine()
    _prewarm(eng_a)
    with eng_a:
        res_a = mk_gen("chaos_base").run_engine(eng_a)
        assert res_a.wait(180)
    base = slo_report(res_a)
    assert base["attainment"] == 1.0, base

    eng_b = _tiny_engine()
    _prewarm(eng_b)
    token = f"serving.engine.{eng_b.engine_id}"
    res_box: list = []
    with eng_b:
        runner = threading.Thread(
            target=lambda: res_box.append(
                mk_gen("chaos_fault").run_engine(eng_b)), daemon=True)
        runner.start()
        time.sleep(0.5)
        fi.reset_injector(fi.FaultInjector(stall=0.8,
                                           stall_point="serving_decode"))
        t_fault = time.monotonic()
        fired = []
        while not fired and time.monotonic() - t_fault < 10:
            fired = [t for t in WATCHDOG.check_once() if t == token]
            # the stalled step holds the step lock: these must not
            assert eng_b.stats()["num_slots"] == 4
            assert not eng_b.draining
            time.sleep(0.05)
        assert fired == [token], "watchdog missed the stalled engine"
        assert time.monotonic() - t_fault < 5.0
        fi.reset_injector(fi.FaultInjector())
        recovered_mono = time.monotonic()
        runner.join(timeout=180)
        assert res_box, "traffic run never finished"
        res_b = res_box[0]
        assert res_b.wait(180)
    WATCHDOG.check_once()
    assert token not in WATCHDOG.stalled()

    rec_off = recovered_mono + 0.8 - res_b.started_at
    assert rec_off < duration - 0.5, "no post-recovery traffic window"
    post_fault = slo_report(res_b, window=(rec_off, float("inf")),
                            gen="chaos_post")
    post_base = slo_report(res_a, window=(rec_off, float("inf")),
                           gen="chaos_post_base")
    assert post_fault["offered"] > 5
    assert post_fault["attainment"] >= post_base["attainment"] - 0.1, \
        (post_fault, post_base)


# ---------------------------------------------------------------------------
# chaos drill 2: a replica process killed behind the router
# ---------------------------------------------------------------------------

REPLICA_HELPER = os.path.join(REPO, "tests", "torch_serving_replica.py")
ROUTER_ENGINE_KW = dict(num_slots=4, num_pages=64, page_size=4,
                        max_seq_len=48)


def _spawn_replica(ep, root, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"PADDLE_TPU_REPLICA_ENDPOINT": ep,
                "REPLICA_CKPT": root,
                "REPLICA_ENGINE_KW": json.dumps(ROUTER_ENGINE_KW)})
    env.update(extra_env or {})
    return subprocess.Popen([sys.executable, REPLICA_HELPER], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_until(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return bool(pred())


def test_router_chaos_kill_failover_respawn_slo(tmp_path):
    """Same-seed generated traffic through the router fronting two
    replica processes; one replica dies mid-run (the PADDLE_PS_FAULT
    kill knob, armed mid-traffic through the helper's arm file) with a
    streamed generate in flight. The router fails the in-flight work
    over exactly once (the reference engine's tokens, a contiguous
    stream, nothing dropped or doubled), respawns the replica from its
    engine checkpoint, and a same-seed run after recovery attains
    within 0.1 of the fault-free one. TTFT is read on the wire
    throughout (streaming generate)."""
    import socket as _socket
    from paddle_tpu_torch.serving import ReplicaSpec, Router

    root = str(tmp_path / "gpt")
    GPTDecodeModel(GPTConfig.tiny(num_layers=1), seed=0,
                   device="cpu").save_checkpoint(root)

    def free_port():
        s = _socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    ep_a, ep_b = (f"127.0.0.1:{free_port()}" for _ in range(2))
    arm = str(tmp_path / "arm_kill")
    # b decodes slowly from the start (a 50 ms stall every decode step,
    # kept out of the stash), so a 30-token stream lasts about 1.5 s and
    # streams a frame a token. The kill knob arms through the file at the
    # stream's first token; the next request b receives (the router's
    # ping, within 0.2 s) ends it at recv: a death mid-decode with the
    # pinned stream in flight
    procs = {"a": _spawn_replica(ep_a, root),
             "b": _spawn_replica(ep_b, root, extra_env={
                 "REPLICA_ARM_FAULT_FILE": arm,
                 "REPLICA_KEEP_FAULTS": "PADDLE_PS_FAULT_STALL,"
                                        "PADDLE_PS_FAULT_STALL_POINT",
                 "PADDLE_PS_FAULT_KILL_AFTER": "1",
                 "PADDLE_PS_FAULT_KILL_POINT": "recv",
                 "PADDLE_PS_FAULT_STALL": "0.05",
                 "PADDLE_PS_FAULT_STALL_POINT": "serving_decode"})}
    death_rc: list = []

    def respawn_b():
        p = procs["b"]
        try:
            # the router sees the reset a beat before the exit is
            # reaped: wait for the real exit code
            death_rc.append(p.wait(timeout=5))
        except subprocess.TimeoutExpired:
            death_rc.append(p.poll())
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
        p2 = _spawn_replica(ep_b, root)      # clean env: no kill knob
        json.loads(p2.stdout.readline())
        procs["b"] = p2
        return ep_b

    def mk_gen(name):
        return LoadGenerator(_traffic(seed=31, duration=2.0, rate=20),
                             name=name)

    router = None
    try:
        for p in list(procs.values()):       # both READY
            json.loads(p.stdout.readline())
        router = Router("127.0.0.1:0",
                        replicas=[ReplicaSpec("a", ep_a),
                                  ReplicaSpec("b", ep_b,
                                              respawn=respawn_b)],
                        ping_interval=0.2, ping_timeout=3.0,
                        suspect_after=1, dead_after=2, token_stall=5.0,
                        failover_retries=2, respawn_cooldown=0.5)
        # the reference output of the pinned long generate: a local
        # engine on the same checkpoint
        ref_eng = Engine.from_checkpoint(root, device="cpu",
                                         **ROUTER_ENGINE_KW)
        with ref_eng:
            expected_long = ref_eng.generate([7, 8], 30,
                                             timeout=60).tolist()
        with router:
            assert _wait_until(
                lambda: router.stats()["healthy_replicas"] == 2, 60)
            cli = ServingClient(router.endpoint)
            # -- the fault-free baseline, streaming TTFT on the wire --
            res_base = mk_gen("rt_base").run_client(cli, timeout=60)
            assert res_base.wait(120)
            rep_base = slo_report(res_base)
            assert rep_base["attainment"] == 1.0, rep_base
            assert rep_base["ttft_ms_p50"] > 0
            base_tokens = {a.index: [int(t) for t in h.generated]
                           for a, h in res_base.handles
                           if h.status == "done"}

            # -- the same seed again, b killed mid-run ----------------
            with router._lock:               # pin the long stream on b
                router._sessions["kill-me"] = "b"
            long_box: dict = {}
            armed = threading.Event()

            def long_gen():
                c = ServingClient(router.endpoint)
                frames = []

                def on_tok(toks, idx):
                    frames.append((idx, list(toks)))
                    if not armed.is_set():
                        # the stream is in flight on b: arm the kill
                        armed.set()
                        open(arm, "w").close()

                long_box["rep"] = c.generate(
                    [7, 8], 30, timeout=120, stream=True,
                    session="kill-me", on_token=on_tok)
                long_box["frames"] = frames
                c.close()

            res_box: list = []
            runner = threading.Thread(
                target=lambda: res_box.append(
                    mk_gen("rt_fault").run_client(cli, timeout=60)),
                daemon=True)
            runner.start()
            time.sleep(0.6)                  # traffic flowing
            lg = threading.Thread(target=long_gen, daemon=True)
            lg.start()
            lg.join(180)
            assert not lg.is_alive()
            assert armed.is_set(), "the stream never produced a token"
            runner.join(180)
            assert res_box and res_box[0].wait(120)
            res_fault = res_box[0]

            # exactly once on the failed-over stream
            rep_long = long_box["rep"]
            assert rep_long["status"] == "done", rep_long
            final = [int(t) for t in np.asarray(
                rep_long["tokens"]).ravel()]
            assert final == expected_long
            streamed: list = []
            for idx, toks in long_box["frames"]:
                assert idx == len(streamed), "stream gap or duplicate"
                streamed.extend(int(t) for t in toks)
            assert streamed == final
            fo = REGISTRY.get("paddle_tpu_router_failovers_total")
            assert sum(s.value for lv, s in fo._series()
                       if lv[0] == router.router_id) >= 1

            # every arrival done in both runs gave the same tokens
            fault_tokens = {a.index: [int(t) for t in h.generated]
                            for a, h in res_fault.handles
                            if h.status == "done"}
            both = set(base_tokens) & set(fault_tokens)
            assert len(both) > 10
            for i in both:
                assert base_tokens[i] == fault_tokens[i], i

            # -- respawned from the engine checkpoint ------------------
            assert _wait_until(lambda: router.stats()["replicas"]["b"][
                "state"] == "healthy", 60), router.stats()
            assert router.stats()["replicas"]["b"]["epoch"] >= 1
            # the fault knob killed b, not the respawner
            assert death_rc and death_rc[0] == fi.KILL_EXIT_CODE, \
                death_rc

            # -- after recovery: the same seed, the attainment band ---
            disp = REGISTRY.get("paddle_tpu_router_dispatch_total")
            b_disp_before = disp.labels(router=router.router_id,
                                        replica="b").value
            res_post = mk_gen("rt_post").run_client(cli, timeout=60)
            assert res_post.wait(120)
            rep_post = slo_report(res_post)
            assert rep_post["attainment"] is not None
            assert rep_post["attainment"] \
                >= rep_base["attainment"] - 0.1, (rep_base, rep_post)
            assert rep_post["ttft_ms_p50"] > 0
            # the respawned replica takes traffic again
            assert disp.labels(router=router.router_id,
                               replica="b").value > b_disp_before
            cli.close()
    finally:
        for p in procs.values():
            p.kill()
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
