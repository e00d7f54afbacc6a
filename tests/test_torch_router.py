"""The port's replicated-serving router (paddle_tpu_torch/serving/
router.py), ServingServer.kill and the wire pieces it stands on, on the
CPU: the cases of tests/test_router.py on the port — wire streaming and
its dedup replay, graceful drain, the router's pick policy (least
loaded, reservation, state, capacity, exclusion, session and prefix
affinity), backpressure, slow start after a respawn, the health state
machine and the stall suspicion that survives green pings, the metric
names, and end to end over in-process replicas: generate and stream
through the router, failover of in-flight streams when a replica is
killed (greedy and sampled, exactly once, contiguous, the killed
replica respawned from its checkpoint), an upstream client dying
mid-stream, drain_replica, a wedged subprocess replica caught by the
inter-frame stall, and the launcher respawning a replica alone. Left
out: the lock sanitizer re-run of the module
(test_router_module_clean_under_lockcheck), which waits for the
analysis package (item 19).

Added, against the JAX package: Router._prefix_key equal for the same
prompts; _pick making the reference's choices over a seeded sequence of
loads, states, sessions, prefixes and exclusions; the JAX package's
ServingClient through the port's Router and the port's client through
the JAX package's Router fronting a port replica (the same tokens, one
final reply, the same rejected / error statuses).

Tiny GPT (hidden 128, 2 layers, vocab 512, initializer range 0.5) on
the CPU; token comparisons are exact (the replicas are one package).
Every wait polls a condition under its own deadline.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import ReplicaSpec as JSpec
from paddle_tpu.serving import Router as JRouter
from paddle_tpu.serving import ServingClient as JClient
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.distributed.fleet.runtime.rpc import RpcClient
from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.serving import (Engine, GPTDecodeModel,
                                      InProcessReplica, PagePool, QueueFull,
                                      ReplicaSpec, Request, Router,
                                      Scheduler, ServingClient,
                                      ServingServer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(vocab_size=512, hidden_size=128, num_heads=2, num_layers=2,
            max_position_embeddings=128, initializer_range=0.5)
ENGINE_KW = dict(num_slots=4, num_pages=64, page_size=4, max_seq_len=48)
CPU_KW = dict(ENGINE_KW, device="cpu")


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fleet") / "gpt")
    cfg = GPTConfig(**SIZE)
    GPTDecodeModel(cfg, params=init_gpt_params(cfg, seed=0),
                   device="cpu").save_checkpoint(root)
    return root


@pytest.fixture(scope="module")
def expected_tokens(ckpt_root):
    """Greedy outputs of a local engine on the same checkpoint: every
    replica must produce exactly these."""
    eng = Engine.from_checkpoint(ckpt_root, **CPU_KW)
    out = {}
    with eng:
        for key, (prompt, mnt) in {"short": ([1, 2, 3], 8),
                                   "long": ([7, 8], 30)}.items():
            out[key] = eng.generate(prompt, mnt, timeout=60).tolist()
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(pred, timeout=60.0, every=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return bool(pred())


def _slow_decode(engine, seconds: float):
    """Make every decode step dawdle (keeps requests in flight for kill
    windows)."""
    orig = engine._decode

    def slow(*a):
        time.sleep(seconds)
        return orig(*a)

    engine._decode = slow


def _contiguous(frames) -> list:
    streamed = []
    for idx, toks in frames:
        assert idx == len(streamed), "stream gap or duplicate"
        streamed.extend(int(t) for t in toks)
    return streamed


def _series_sum(name, router_id) -> float:
    m = REGISTRY.get(name)
    return sum(s.value for lv, s in m._series() if lv[0] == router_id)


# ---------------------------------------------------------------------------
# wire streaming (single replica, no router)
# ---------------------------------------------------------------------------

def test_stream_matches_oneshot_and_ttft_before_final(ckpt_root,
                                                      expected_tokens):
    eng = Engine.from_checkpoint(ckpt_root, **CPU_KW)
    with eng, ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            frames = []
            rep = cli.generate(
                [1, 2, 3], 8, timeout=60, stream=True,
                on_token=lambda t, i: frames.append(
                    (i, list(t), time.monotonic())))
            done_at = time.monotonic()
            assert rep["status"] == "done"
            final = np.asarray(rep["tokens"]).tolist()
            assert final == expected_tokens["short"]
            assert _contiguous([(i, t) for i, t, _ in frames]) == final
            assert len(frames) >= 2          # actually incremental
            # TTFT is observable on the wire: the first token frame
            # lands strictly before the call finished
            assert frames[0][2] < done_at
            one_shot = cli.generate([1, 2, 3], 8, timeout=60)
            assert np.asarray(one_shot["tokens"]).tolist() == final
        finally:
            cli.close()


def test_stream_dedup_retry_replays_final_only(ckpt_root):
    """A retried streamed generate (same wire request id) is answered
    from the dedup cache: final frame only, the same tokens — the
    exactly-once contract the router's failover leans on."""
    eng = Engine.from_checkpoint(ckpt_root, **CPU_KW)
    with eng, ServingServer(eng, "127.0.0.1:0") as srv:
        rpc = RpcClient(srv.endpoint)
        try:
            req = {"op": "generate", "prompt": np.asarray([1, 2, 3],
                                                          np.int32),
                   "max_new_tokens": 6, "timeout": 60, "stream": True}
            rid = 0xA110_0001
            first_frames, retry_frames = [], []
            rep1 = rpc.call(req, timeout=60, req_id=rid,
                            on_stream=first_frames.append)
            rep2 = rpc.call(req, timeout=60, req_id=rid,
                            on_stream=retry_frames.append)
            assert len(first_frames) >= 2
            assert retry_frames == []        # dedup hit: final only
            assert np.asarray(rep1["tokens"]).tolist() \
                == np.asarray(rep2["tokens"]).tolist()
            assert eng.stats()["completed"] == 1   # decoded once
        finally:
            rpc.close()


def test_client_on_token_dedups_replayed_frames():
    """A mid-stream transport retry re-streams from index 0:
    ServingClient.generate forwards each token to on_token exactly once
    (index-based tail dedup)."""
    cli = ServingClient.__new__(ServingClient)   # no real connection

    class _FakeRpc:
        def call(self, req, timeout=None, deadline=None,
                 on_stream=None):
            frames = (
                {"tokens": np.asarray([1, 2], np.int32), "index": 0},
                # the retry replays from scratch, one token further on
                {"tokens": np.asarray([1, 2, 3], np.int32), "index": 0},
                {"tokens": np.asarray([4], np.int32), "index": 3},
            )
            for fr in frames:
                on_stream(fr)
            return {"status": "done",
                    "tokens": np.asarray([1, 2, 3, 4], np.int32)}

    cli._rpc = _FakeRpc()
    got = []
    rep = cli.generate([9], 4, stream=True,
                       on_token=lambda t, i: got.append((i, list(t))))
    assert got == [(0, [1, 2]), (2, [3]), (3, [4])]
    assert np.asarray(rep["tokens"]).tolist() == [1, 2, 3, 4]


def test_request_next_tokens_streams_incrementally():
    pool = PagePool(16, 4)
    s = Scheduler(pool, 1, max_seq_len=64)
    r = s.submit(Request([1, 2], 3))
    got, = s.admit()
    assert got is r
    toks, done = r.next_tokens(0, timeout=0.01)
    assert toks == [] and not done           # nothing yet; no block
    s.record_token(r, 7)
    toks, done = r.next_tokens(0, timeout=1.0)
    assert toks == [7] and not done
    s.record_token(r, 8)
    s.record_token(r, 9)                     # finishes (max_new=3)
    toks, done = r.next_tokens(1, timeout=1.0)
    assert toks == [8, 9] and done


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_scheduler_drain_rejects_new_keeps_queue():
    pool = PagePool(16, 4)
    s = Scheduler(pool, 1, max_seq_len=64)
    queued = s.submit(Request([1], 2))
    s.drain()
    with pytest.raises(QueueFull):
        s.submit(Request([1], 2))
    assert s.stats()["draining"] is True
    assert s.stats()["rejected"] == 1
    got, = s.admit()                         # the queue still drains
    assert got is queued
    s.record_token(got, 1)
    s.record_token(got, 2)
    assert queued.status == "done"


def test_drained_replica_finishes_queue_before_exit(ckpt_root):
    """Drain stops admission, not the queue: every request accepted
    before the drain verb completes."""
    eng = Engine.from_checkpoint(ckpt_root, **CPU_KW)
    _slow_decode(eng, 0.02)
    with eng, ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            handles = [eng.submit([1, 2], 6) for _ in range(5)]
            assert cli.ping_info()["draining"] is False
            rep = cli.drain(wait=True, timeout=60)
            assert rep["draining"] and rep["idle"]
            assert all(h.status == "done" and len(h.generated) == 6
                       for h in handles)
            assert cli.ping_info()["draining"] is True
            post = cli.generate([3], 2, timeout=30)
            assert post["status"] == "rejected"
            assert "draining" in post["error"]
        finally:
            cli.close()


# ---------------------------------------------------------------------------
# router policy units (no replica contacted: _pick is pure in-memory)
# ---------------------------------------------------------------------------

@pytest.fixture
def bare_router():
    r = Router("127.0.0.1:0", ping_interval=3600, max_inflight=4)
    yield r
    r.server_close()


def _fake_replicas(router, n, spec=ReplicaSpec):
    reps = [router.add_replica(spec(f"r{i}", f"127.0.0.1:{i + 1}"))
            for i in range(n)]
    for r in reps:
        # born unconfirmed (respawning): confirm it the way the health
        # loop would
        assert r.state == "respawning"
        router._note_alive(r, {"ok": True})
        assert r.state == "healthy"
        assert r.capacity == r.max_inflight   # first join: no ramp
    return reps


def test_pick_least_loaded_and_reservation(bare_router):
    a, b, c = _fake_replicas(bare_router, 3)
    a.last_info = {"queue_depth": 5, "active_slots": 2}
    b.last_info = {"queue_depth": 0, "active_slots": 1}
    c.last_info = {"queue_depth": 0, "active_slots": 1,
                   "occupancy": 0.9}
    b.last_info["occupancy"] = 0.1
    got = bare_router._pick(None, set())
    assert got is b                          # ties break on occupancy
    # the reservation counts as load for the next pick
    b.last_info = {"queue_depth": 0, "active_slots": 0}
    c.last_info = {"queue_depth": 0, "active_slots": 0}
    for _ in range(4):
        bare_router._pick(None, set())
    st = bare_router.stats()
    assert st["replicas"]["r0"]["inflight"] == 0
    assert st["replicas"]["r1"]["inflight"] \
        + st["replicas"]["r2"]["inflight"] == 5


def test_pick_respects_state_capacity_and_exclusion(bare_router):
    a, b = _fake_replicas(bare_router, 2)
    a.state = "suspect"
    got = bare_router._pick(None, set())
    assert got is b
    bare_router._release(b, True)
    got = bare_router._pick(None, {"r1"})
    assert got is None                       # b excluded, a suspect
    a.state = "healthy"
    a.inflight = a.max_inflight              # saturated
    assert bare_router._pick(None, {"r1"}) is None
    a.inflight = 0
    assert bare_router._pick(None, {"r1"}) is a


def test_session_affinity_sticks_until_unroutable(bare_router):
    a, b = _fake_replicas(bare_router, 2)
    first = bare_router._pick("sess", set())
    bare_router._release(first, True)
    # heavy load elsewhere must not move the session
    other = a if first is b else b
    other.last_info = {}
    first.last_info = {"queue_depth": 50}
    again = bare_router._pick("sess", set())
    assert again is first
    bare_router._release(again, True)
    # transient saturation: THIS request spills sideways, but the
    # session does not remap
    first.last_info = {}
    first.inflight = first.max_inflight
    spill = bare_router._pick("sess", set())
    assert spill is other
    bare_router._release(spill, True)
    first.inflight = 0
    back = bare_router._pick("sess", set())
    assert back is first
    bare_router._release(back, True)
    # unroutable owner: the session remaps, and stays remapped
    first.state = "dead"
    moved = bare_router._pick("sess", set())
    assert moved is other
    bare_router._release(moved, True)
    first.state = "healthy"
    assert bare_router._pick("sess", set()) is other


def test_prefix_affinity_hint_sticks_and_self_heals(bare_router):
    """Sessionless requests sharing a prompt prefix prefer the replica
    that served it last; the hint never overrides capacity, failover
    exclusion or session affinity, and re-learns whenever the pick
    falls through."""
    a, b = _fake_replicas(bare_router, 2)
    pfx = Router._prefix_key([3, 1, 4, 1, 5, 9, 2, 6])
    assert pfx != Router._prefix_key([9, 9, 9])
    first = bare_router._pick(None, set(), prefix=pfx)
    other = b if first is a else a
    bare_router._release(first, True)
    for _ in range(3):
        got = bare_router._pick(None, set(), prefix=pfx)
        assert got is first
        bare_router._release(got, True)
    # failover exclusion beats the hint, and the fallback rewrites it
    got = bare_router._pick(None, {first.name}, prefix=pfx)
    assert got is other
    bare_router._release(got, True)
    got = bare_router._pick(None, set(), prefix=pfx)
    assert got is other
    bare_router._release(got, True)
    # an at-capacity preferred replica: the request spills sideways and
    # the hint moves with it
    other.inflight = other.max_inflight
    got = bare_router._pick(None, set(), prefix=pfx)
    assert got is first
    bare_router._release(got, True)
    other.inflight = 0
    got = bare_router._pick(None, set(), prefix=pfx)
    assert got is first
    bare_router._release(got, True)
    # a dead preferred replica falls through the same way
    for _ in range(3):
        bare_router._note_failure(first, "ping")
    assert first.state == "dead"
    got = bare_router._pick(None, set(), prefix=pfx)
    assert got is other
    bare_router._release(got, True)
    # session affinity outranks the prefix hint
    first.state = "healthy"
    bare_router._sessions["chat-9"] = first.name
    got = bare_router._pick("chat-9", set(), prefix=pfx)
    assert got is first
    bare_router._release(got, True)
    # and a session-keyed pick never overwrites the prefix hint
    got = bare_router._pick(None, set(), prefix=pfx)
    assert got is other
    bare_router._release(got, True)


def test_relay_rejects_when_no_capacity(bare_router):
    (a,) = _fake_replicas(bare_router, 1)
    a.state = "dead"
    gen = bare_router._relay({"prompt": np.asarray([1], np.int32),
                              "max_new_tokens": 2, "timeout": 5}, None)
    with pytest.raises(StopIteration) as stop:
        next(gen)
    rep = stop.value.value
    assert rep["status"] == "rejected"
    assert "no routable replica" in rep["error"]


def test_slow_start_ramp_after_respawn(bare_router):
    (a,) = _fake_replicas(bare_router, 1)
    for _ in range(3):                       # the real path to dead
        bare_router._note_failure(a, "ping")
    assert a.state == "dead"
    bare_router._note_alive(a, {"ok": True})
    assert a.state == "healthy"
    assert a.capacity == 1                   # warm-start re-admission
    got = bare_router._pick(None, set())
    assert got is a
    assert bare_router._pick(None, set()) is None   # cap honoured
    bare_router._release(a, True)            # success doubles the cap
    assert a.capacity == 2
    bare_router._release(a, True)
    assert a.capacity == 4 == a.max_inflight


def test_health_transitions_and_draining_retires(bare_router):
    a, b = _fake_replicas(bare_router, 2)
    bare_router._note_failure(a, "ping")
    assert a.state == "suspect"              # suspect_after=1
    bare_router._note_failure(a, "ping")
    bare_router._note_failure(a, "ping")
    assert a.state == "dead"                 # dead_after=3
    bare_router._note_alive(a, {"ok": True})
    assert a.state == "healthy"
    # a draining replica that goes dark retires: never respawned
    bare_router._note_alive(b, {"ok": True, "draining": True})
    assert b.state == "draining"
    for _ in range(3):
        bare_router._note_failure(b, "ping")
    assert b.state == "retired"
    # stale-epoch failures (a pre-respawn incarnation) are ignored
    bare_router._note_failure(a, "transport", epoch=a.epoch - 1)
    assert a.state == "healthy" and a.consecutive_errors == 0


def test_stall_suspicion_survives_green_pings(bare_router):
    """A wedged decode step answers pings: inside the stall hold a green
    probe does not clear suspicion, and a replica wedged for good still
    escalates to dead, because pings cannot reset the stall ledger;
    only a completed forward can."""
    (a,) = _fake_replicas(bare_router, 1)
    bare_router._note_failure(a, "stall")
    assert a.state == "suspect"
    bare_router._note_alive(a, {"ok": True})
    assert a.state == "suspect"              # held
    a.suspect_until = 0.0                    # the hold expires
    bare_router._note_alive(a, {"ok": True})
    assert a.state == "healthy"
    assert a.stall_errors == 1               # the ping did not clear it
    bare_router._note_failure(a, "stall")    # ledger: 2
    a.suspect_until = 0.0
    bare_router._note_alive(a, {"ok": True})
    assert a.state == "healthy"
    bare_router._note_failure(a, "stall")    # ledger: 3 -> dead
    assert a.state == "dead" and a.cold
    a.suspect_until = 0.0
    bare_router._note_alive(a, {"ok": True})
    assert a.state == "healthy" and a.stall_errors == 0
    bare_router._note_failure(a, "stall")
    a.inflight = 1
    bare_router._release(a, True)            # a forward completed
    assert a.stall_errors == 0


def test_router_required_metric_names_registered():
    for name in ("paddle_tpu_router_requests_total",
                 "paddle_tpu_router_dispatch_total",
                 "paddle_tpu_router_failovers_total",
                 "paddle_tpu_router_replica_state",
                 "paddle_tpu_router_respawns_total",
                 "paddle_tpu_router_stream_stalls_total",
                 "paddle_tpu_router_inflight",
                 "paddle_tpu_tenant_router_requests_total"):
        assert REGISTRY.get(name) is not None, name


# ---------------------------------------------------------------------------
# parity of the policy with the JAX package's router
# ---------------------------------------------------------------------------

def test_prefix_key_equals_the_reference():
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, (n,)) for n in (1, 5, 63, 64, 65, 200)]
    prompts += [[3, 1, 4], np.asarray([[1, 2], [3, 4]], np.int32)]
    for p in prompts:
        assert Router._prefix_key(p) == JRouter._prefix_key(p)
    # only the leading 64 tokens count
    assert Router._prefix_key(list(range(64)) + [1]) \
        == Router._prefix_key(list(range(64)) + [2])


def test_pick_matches_the_reference_router():
    """The same seeded sequence of probes, failures, load reports,
    state changes, picks (sessions, prefixes, exclusions) and releases
    on both packages' routers: every pick names the same replica, and
    the sessions, prefix hints and reservations end equal."""
    rng = np.random.RandomState(11)
    routers = [Router("127.0.0.1:0", ping_interval=3600, max_inflight=3),
               JRouter("127.0.0.1:0", ping_interval=3600, max_inflight=3)]
    try:
        fleets = [_fake_replicas(routers[0], 4),
                  _fake_replicas(routers[1], 4, spec=JSpec)]
        prefixes = [Router._prefix_key(rng.randint(0, 512, (8,)))
                    for _ in range(3)]
        held = [[], []]
        picks = [[], []]
        for _ in range(600):
            op = rng.randint(6)
            i = rng.randint(4)
            info = {"queue_depth": int(rng.randint(4)),
                    "active_slots": int(rng.randint(4)),
                    "occupancy": float(rng.randint(5)) / 4}
            session = [None, "s0", "s1"][rng.randint(3)]
            prefix = [None, *prefixes][rng.randint(4)]
            exclude = {f"r{j}" for j in range(4) if rng.rand() < 0.15}
            ok = bool(rng.rand() < 0.8)
            reason = ["ping", "transport", "stall"][rng.randint(3)]
            for k, (rt, reps) in enumerate(zip(routers, fleets)):
                if op == 0:
                    rt._note_alive(reps[i], info)
                elif op == 1:
                    rt._note_failure(reps[i], reason)
                    reps[i].suspect_until = 0.0
                elif op == 2 and held[k]:
                    rt._release(held[k].pop(0), ok)
                else:
                    got = rt._pick(session, exclude, prefix=prefix)
                    picks[k].append(None if got is None else got.name)
                    if got is not None:
                        held[k].append(got)
        assert picks[0] == picks[1]
        assert sum(p is not None for p in picks[0]) > 100
        assert len(set(picks[0])) == 5       # every replica and None
        assert dict(routers[0]._sessions) == dict(routers[1]._sessions)
        assert dict(routers[0]._prefix_affinity) \
            == dict(routers[1]._prefix_affinity)
        for a, b in zip(*fleets):
            assert (a.state, a.inflight, a.capacity, a.stall_errors) \
                == (b.state, b.inflight, b.capacity, b.stall_errors)
    finally:
        for rt in routers:
            rt.server_close()


# ---------------------------------------------------------------------------
# router end to end (in-process replicas)
# ---------------------------------------------------------------------------

def _replicas(ckpt_root, n):
    reps = []
    for i in range(n):
        r = InProcessReplica(ckpt_root, name=f"rep{i}", engine_kw=CPU_KW)
        r.start()
        reps.append(r)
    return reps


def _fleet(ckpt_root, n=2, **router_kw):
    reps = _replicas(ckpt_root, n)
    kw = dict(ping_interval=0.1, ping_timeout=1.0, suspect_after=1,
              dead_after=2, token_stall=5.0, respawn_cooldown=0.2)
    kw.update(router_kw)
    router = Router("127.0.0.1:0", replicas=[r.spec() for r in reps],
                    **kw)
    return router, reps


def _kill_the_busy_one(router, reps):
    """Wait until the streams are in flight, then kill the replica that
    holds them (prefix affinity converges same-prompt traffic on one)."""
    assert _wait(lambda: any(v["inflight"] > 0 for v in
                             router.stats()["replicas"].values())
                 and any(r.engine.stats()["admitted"] > 0 for r in reps),
                 timeout=60)
    infl = router.stats()["replicas"]
    victim = max(reps, key=lambda r: infl[r.name]["inflight"])
    assert infl[victim.name]["inflight"] > 0
    victim.kill()                            # crash, no drain
    return victim


def test_router_generate_stream_and_watchdog_tokens(ckpt_root,
                                                    expected_tokens):
    from paddle_tpu_torch.observability.watchdog import WATCHDOG
    router, reps = _fleet(ckpt_root)
    try:
        with router:
            toks = WATCHDOG.tokens()
            for r in reps:
                assert f"serving.router.{router.router_id}." \
                       f"{r.name}" in toks
            cli = ServingClient(router.endpoint)
            try:
                rep = cli.generate([1, 2, 3], 8, timeout=60)
                assert rep["status"] == "done"
                assert np.asarray(rep["tokens"]).tolist() \
                    == expected_tokens["short"]
                frames = []
                rep2 = cli.generate([1, 2, 3], 8, timeout=60,
                                    stream=True,
                                    on_token=lambda t, i:
                                    frames.append((i, list(t))))
                streamed = _contiguous(frames)
                assert streamed == expected_tokens["short"]
                assert np.asarray(rep2["tokens"]).tolist() == streamed
                # session affinity end to end: all four on ONE engine
                before = [r.engine.stats()["admitted"] for r in reps]
                for _ in range(4):
                    assert cli.generate([4, 5], 2, timeout=60,
                                        session="chat-1")["status"] \
                        == "done"
                deltas = [r.engine.stats()["admitted"] - b
                          for r, b in zip(reps, before)]
                assert sorted(deltas) == [0, 4]
                assert router.stats()["healthy_replicas"] == 2
            finally:
                cli.close()
    finally:
        for r in reps:
            r.stop()


def test_failover_on_replica_kill_exactly_once(ckpt_root,
                                               expected_tokens):
    """Kill a replica with streams in flight: the router replays them on
    the survivor with the same wire ids; every client sees exactly one
    complete, duplicate-free token sequence; the dead replica respawns
    from its checkpoint and rejoins."""
    router, reps = _fleet(ckpt_root)
    try:
        with router:
            for r in reps:
                _slow_decode(r.engine, 0.03)
            results, frame_logs = [], []

            def long_gen():
                c = ServingClient(router.endpoint)
                frames = []
                rep = c.generate([7, 8], 30, timeout=120, stream=True,
                                 on_token=lambda t, i:
                                 frames.append((i, list(t))))
                c.close()
                results.append(rep)
                frame_logs.append(frames)

            ths = [threading.Thread(target=long_gen) for _ in range(4)]
            for t in ths:
                t.start()
            victim = _kill_the_busy_one(router, reps)
            for t in ths:
                t.join(180)
            assert not any(t.is_alive() for t in ths)
            assert len(results) == 4
            for rep, frames in zip(results, frame_logs):
                assert rep["status"] == "done", rep
                final = np.asarray(rep["tokens"]).tolist()
                assert final == expected_tokens["long"]
                assert _contiguous(frames) == final
            assert _series_sum("paddle_tpu_router_failovers_total",
                               router.router_id) >= 1
            # elastic respawn: rebuilt from its checkpoint, readmitted
            # after ready pings, epoch bumped
            assert _wait(lambda: router.stats()["replicas"][victim.name][
                "state"] == "healthy", timeout=60), router.stats()
            assert router.stats()["replicas"][victim.name]["epoch"] >= 1
            cli = ServingClient(router.endpoint)
            try:
                for _ in range(3):
                    assert cli.generate([1, 2, 3], 4, timeout=60)[
                        "status"] == "done"
            finally:
                cli.close()
    finally:
        for r in reps:
            r.stop()


def test_failover_sampled_stream_replays_bit_identical(ckpt_root):
    """Kill a replica mid-stream with temperature > 0: the survivor
    replays each request with the same wire id and seed, and the Philox
    sampler is keyed by (seed, step), so every relayed stream is
    contiguous and equal to the same-seed run on a fault-free fleet."""
    seeds = [1000 + i for i in range(4)]
    samp = dict(temperature=0.8, top_k=20, top_p=0.95)

    def run_fleet(kill):
        router, reps = _fleet(ckpt_root)
        outs = [None] * len(seeds)
        logs = [None] * len(seeds)
        try:
            with router:
                if kill:
                    for r in reps:
                        _slow_decode(r.engine, 0.03)

                def gen(i):
                    c = ServingClient(router.endpoint)
                    frames = []
                    rep = c.generate([7, 8], 30, timeout=120,
                                     stream=True, seed=seeds[i], **samp,
                                     on_token=lambda t, idx:
                                     frames.append((idx, list(t))))
                    c.close()
                    outs[i] = rep
                    logs[i] = frames

                ths = [threading.Thread(target=gen, args=(i,))
                       for i in range(len(seeds))]
                for t in ths:
                    t.start()
                if kill:
                    _kill_the_busy_one(router, reps)
                for t in ths:
                    t.join(180)
                assert not any(t.is_alive() for t in ths)
                fo_n = _series_sum("paddle_tpu_router_failovers_total",
                                   router.router_id)
        finally:
            for r in reps:
                r.stop()
        return outs, logs, fo_n

    base_out, _, base_fo = run_fleet(kill=False)
    assert base_fo == 0                      # the baseline is fault-free
    baseline = []
    for rep in base_out:
        assert rep["status"] == "done", rep
        baseline.append(np.asarray(rep["tokens"]).tolist())
        assert len(baseline[-1]) == 30
    assert len({tuple(t) for t in baseline}) > 1   # sampling is live
    chaos_out, chaos_logs, chaos_fo = run_fleet(kill=True)
    assert chaos_fo >= 1
    for i, (rep, frames) in enumerate(zip(chaos_out, chaos_logs)):
        assert rep["status"] == "done", rep
        final = np.asarray(rep["tokens"]).tolist()
        assert _contiguous(frames) == final
        assert final == baseline[i]


def test_upstream_death_mid_stream_releases_reservation(ckpt_root):
    """A client that vanishes mid-stream through the router must not
    leak the replica's in-flight reservation, and the replica-side
    request is cancelled."""
    router, reps = _fleet(ckpt_root, n=1)
    try:
        with router:
            _slow_decode(reps[0].engine, 0.03)
            rpc = RpcClient(router.endpoint)
            gen = rpc.call_stream(
                {"op": "generate",
                 "prompt": np.asarray([7, 8], np.int32),
                 "max_new_tokens": 30, "timeout": 60, "stream": True},
                timeout=30)
            next(gen)                        # the stream is established
            gen.close()                      # upstream dies mid-stream
            rpc.close()
            assert _wait(lambda: router.stats()["replicas"]["rep0"][
                "inflight"] == 0 and reps[0].engine.scheduler.idle,
                timeout=60), (router.stats(), reps[0].engine.stats())
    finally:
        for r in reps:
            r.stop()


def test_drain_replica_via_router(ckpt_root):
    router, reps = _fleet(ckpt_root)
    try:
        with router:
            rpc = RpcClient(router.endpoint)
            cli = ServingClient(router.endpoint)
            try:
                out = rpc.call({"op": "drain_replica",
                                "replica": "rep0", "wait": True},
                               timeout=90, deadline=120)
                assert out["draining"] and out["idle"]
                assert reps[0].engine.draining
                # the drained replica is out of rotation; traffic flows
                for _ in range(3):
                    assert cli.generate([1, 2], 3, timeout=60)[
                        "status"] == "done"
                assert reps[0].engine.stats()["admitted"] == 0
                assert router.stats()["replicas"]["rep0"]["state"] \
                    == "draining"
            finally:
                cli.close()
                rpc.close()
    finally:
        for r in reps:
            r.stop()


def _spawn_replica(env_extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_serving_replica.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_stream_stall_knob_fails_over_subprocess(ckpt_root,
                                                 expected_tokens):
    """PADDLE_PS_FAULT_STALL at serving_decode wedges a subprocess
    replica's decode inside its step lock; its front end still answers
    pings, so only the router's inter-frame stall timeout can catch it
    mid-generation and fail the stream over to the survivor."""
    proc = _spawn_replica({
        "PADDLE_TPU_REPLICA_ENDPOINT": f"127.0.0.1:{_free_port()}",
        "REPLICA_CKPT": ckpt_root,
        "REPLICA_ENGINE_KW": json.dumps(ENGINE_KW),
        "PADDLE_PS_FAULT_STALL": "60",
        "PADDLE_PS_FAULT_STALL_POINT": "serving_decode"})
    survivor = InProcessReplica(ckpt_root, name="good", engine_kw=CPU_KW)
    survivor.start()
    try:
        # the survivor's first prefill and decode run before the drill
        survivor.engine.generate([7, 8], 2, timeout=120)
        ready = json.loads(proc.stdout.readline())
        router = Router(
            "127.0.0.1:0",
            replicas=[ReplicaSpec("wedged", ready["endpoint"]),
                      survivor.spec()],
            ping_interval=0.1, ping_timeout=1.0, token_stall=1.0,
            suspect_hold=30.0, dead_after=10)
        with router:
            assert _wait(lambda: router.stats()["healthy_replicas"] == 2,
                         timeout=60)
            with router._lock:               # pin the stream on it
                router._sessions["s"] = "wedged"
            cli = ServingClient(router.endpoint)
            try:
                t0 = time.monotonic()
                rep = cli.generate([7, 8], 30, timeout=90, stream=True,
                                   session="s")
                took = time.monotonic() - t0
            finally:
                cli.close()
            assert rep["status"] == "done"
            assert np.asarray(rep["tokens"]).tolist() \
                == expected_tokens["long"]
            # detection was the token stall, not the 90 s timeout
            assert took < 30, took
            assert _series_sum("paddle_tpu_router_stream_stalls_total",
                               router.router_id) >= 1
            st = router.stats()
            assert st["replicas"]["wedged"]["state"] in ("suspect",
                                                         "dead")
            # green pings did not clear the held suspicion
            time.sleep(0.5)
            assert router.stats()["replicas"]["wedged"]["state"] \
                != "healthy"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        survivor.stop()


def test_launch_respawns_replica_alone_subprocess(ckpt_root, tmp_path):
    """The launcher's --serving_replicas: a replica child that dies (the
    kill knob) is respawned alone from its engine checkpoint under
    --max_restarts, and serves again on the same endpoint."""
    port = _free_port()
    arm = str(tmp_path / "arm_kill")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update({"REPLICA_CKPT": ckpt_root,
                "REPLICA_ENGINE_KW": json.dumps(ENGINE_KW),
                "REPLICA_ARM_FAULT_FILE": arm,
                "PADDLE_PS_FAULT_KILL_AFTER": "1",
                "PADDLE_PS_FAULT_KILL_POINT": "recv"})
    launcher = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--serving_replicas", f"127.0.0.1:{port}",
         "--max_restarts", "1",
         os.path.join(REPO, "tests", "torch_serving_replica.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def try_generate() -> bool:
        """One bounded attempt, no client-side retries."""
        rc = RpcClient(f"127.0.0.1:{port}", timeout=10, deadline=10,
                       max_retries=0)
        try:
            rep = rc.call({"op": "generate",
                           "prompt": np.asarray([1, 2], np.int32),
                           "max_new_tokens": 3, "timeout": 10},
                          timeout=10, deadline=10)
            return rep.get("status") == "done"
        except Exception:
            return False
        finally:
            rc.close()

    try:
        assert _wait(try_generate, timeout=120, every=0.25), \
            "replica never came up"
        open(arm, "w").close()
        time.sleep(0.3)                      # the child polls the file
        try_generate()                       # burns the kill (dies@recv)
        os.unlink(arm)                       # the respawn must not re-arm
        assert _wait(try_generate, timeout=120, every=0.5), \
            "respawned replica never served"
    finally:
        launcher.terminate()
        try:
            launcher.wait(timeout=30)
        except subprocess.TimeoutExpired:
            launcher.kill()
            launcher.wait(timeout=30)


# ---------------------------------------------------------------------------
# one wire for two packages
# ---------------------------------------------------------------------------

def _statuses_through(router_ep, client_cls, expected_tokens, drain):
    """generate, a stream, an oversized prompt and a drained fleet,
    through the router at `router_ep` with `client_cls`."""
    cli = client_cls(router_ep)
    try:
        rep = cli.generate([1, 2, 3], 8, timeout=60)
        assert rep["status"] == "done"
        assert np.asarray(rep["tokens"]).tolist() \
            == expected_tokens["short"]
        frames = []
        rep = cli.generate([7, 8], 30, timeout=60, stream=True,
                           on_token=lambda t, i: frames.append((i, list(t))))
        assert rep["status"] == "done"
        assert _contiguous(frames) == np.asarray(rep["tokens"]).tolist() \
            == expected_tokens["long"]
        # prompt + max_new past max_seq_len: the replica's error, relayed
        bad = cli.generate(list(range(40)), 30, timeout=60)
        assert bad["status"] == "error", bad
        drain()
        rej = cli.generate([1, 2, 3], 4, timeout=60)
        assert rej["status"] == "rejected", rej
        return [rep["status"], bad["status"], rej["status"]]
    finally:
        cli.close()


def test_reference_client_through_the_port_router(ckpt_root,
                                                  expected_tokens):
    router, reps = _fleet(ckpt_root, n=1)
    try:
        with router:
            done0 = _series_sum("paddle_tpu_router_requests_total",
                                router.router_id)
            got = _statuses_through(
                router.endpoint, JClient, expected_tokens,
                lambda: reps[0].engine.drain())
            assert got == ["done", "error", "rejected"]
            # one final reply a request: four requests, four outcomes
            assert _series_sum("paddle_tpu_router_requests_total",
                               router.router_id) - done0 == 4
    finally:
        for r in reps:
            r.stop()


def test_port_client_through_the_reference_router(ckpt_root,
                                                  expected_tokens):
    reps = _replicas(ckpt_root, 1)
    router = JRouter("127.0.0.1:0",
                     replicas=[JSpec(r.name, r.endpoint) for r in reps],
                     ping_interval=0.1, ping_timeout=1.0)
    try:
        with router:
            assert _wait(lambda: router.stats()["healthy_replicas"] == 1,
                         timeout=60)
            got = _statuses_through(
                router.endpoint, ServingClient, expected_tokens,
                lambda: reps[0].engine.drain())
            assert got == ["done", "error", "rejected"]
            assert reps[0].engine.stats()["completed"] == 2
    finally:
        for r in reps:
            r.stop()
