"""The port's tiered embedding store
(paddle_tpu_torch/distributed/fleet/runtime/tiered_store.py and its
PSServer hooks) against the JAX package's: eviction and admission under
a tiny byte budget, bitwise parity with an all-warm table (same rows,
same RNG stream), WAL-restart, HA failover and handoff with cold rows,
cold-read faults contained to one pull, chunk GC, the same exported
state as the reference's TieredTable after the same interleaving, and a
Downpour worker process over a mostly cold table equal to an all-warm
run."""
import threading
import time

import numpy as np
import pytest

import torch_ps_workers as W
from paddle_tpu.checkpoint.store import CheckpointStore as RefStore
from paddle_tpu.distributed.fleet.runtime import \
    parameter_server_runtime as ref_ps
from paddle_tpu.distributed.fleet.runtime import tiered_store as ref_ts
from paddle_tpu_torch.checkpoint.store import CheckpointStore
from paddle_tpu_torch.distributed.fleet import ps_roles
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.distributed.fleet.runtime import rpc
from paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime \
    import LargeScaleKV, PSClient, PSServer
from paddle_tpu_torch.distributed.fleet.runtime.tiered_store import (
    ColdReadError, TieredTable, gc_cold_store)

DIM = 4
ROW = DIM * 4  # float32 row bytes


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


@pytest.fixture
def numpy_kv(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")


def _store(tmp_path, name="store"):
    return CheckpointStore(str(tmp_path / name), keep=0)


def _table(tmp_path, warm_rows=8, **kw):
    return TieredTable(DIM, seed=7, store=_store(tmp_path), name="t",
                       warm_bytes=warm_rows * ROW, **kw)


def _state_dict(t):
    st = t.export_state()
    return {int(k): st["rows"][i].copy()
            for i, k in enumerate(st["keys"])}, st["rng"]


def _assert_same(a, b):
    """Bitwise table equality independent of row order, plus the RNG
    stream position."""
    da, ra = _state_dict(a)
    db, rb = _state_dict(b)
    assert set(da) == set(db)
    for k in da:
        assert np.array_equal(da[k], db[k]), f"row {k} diverged"
    assert ra["pos"] == rb["pos"]
    assert np.array_equal(ra["key"], rb["key"])


def _stop(*servers):
    for s in servers:
        s.shutdown()
        s.server_close()


# ---------------------------------------------------------------------------
# admission / eviction under a tiny byte budget
# ---------------------------------------------------------------------------

def test_watermark_eviction_respects_budget(tmp_path):
    t = _table(tmp_path, warm_rows=8)
    t.pull(np.arange(64))
    before, _ = _state_dict(t)
    t.drain()
    st = t.stats()
    assert st["warm_bytes"] <= 8 * ROW
    assert st["cold_rows"] > 0
    assert st["warm_rows"] + st["cold_rows"] == 64
    after, _ = _state_dict(t)
    for k in before:
        assert np.array_equal(before[k], after[k])


def test_pull_only_workload_demotes_clean(tmp_path):
    """Rows faulted back untouched revert to their cold copy: no store
    write, no new segment."""
    t = _table(tmp_path, warm_rows=8)
    t.pull(np.arange(32))
    t.drain()
    flush0 = t.stats()["demoted_flush"]
    t.pull(np.arange(32))
    t.drain()
    st = t.stats()
    assert st["demoted_clean"] >= 32 - 2 * 8
    assert st["demoted_flush"] - flush0 <= 8
    assert st["warm_bytes"] <= 8 * ROW


def test_hot_rows_stay_warm_under_skew(tmp_path):
    t = _table(tmp_path, warm_rows=8)
    hot = np.arange(4)
    for i in range(40):
        t.pull(hot)
        t.pull(np.asarray([100 + i]))
    t.drain()
    assert t.stats()["warm_bytes"] <= 8 * ROW
    with t._lock:
        warm = set(t._index)
    assert set(int(k) for k in hot) <= warm


def test_push_to_cold_row_faults_then_applies(tmp_path):
    t = _table(tmp_path, warm_rows=4)
    base = t.pull(np.arange(16)).copy()
    t.drain()
    assert t.stats()["cold_rows"] > 0
    t.push(np.arange(16), np.ones((16, DIM), np.float32), lr=0.5)
    np.testing.assert_array_equal(t.pull(np.arange(16)), base - 0.5)


def test_background_demoter_thread(tmp_path):
    t = _table(tmp_path, warm_rows=8, demote_interval=0.01)
    try:
        t.pull(np.arange(64))
        W.wait_for(lambda: t.warm_resident_bytes() <= 8 * ROW,
                   what="background demotion under budget")
    finally:
        t.close()


def test_access_wider_than_the_budget_faults_each_row_once(tmp_path):
    """A pull, a push and a rows_for over far more rows than the warm
    budget, while the background demoter runs every millisecond: each
    completes with every row faulted in at most once (the reference's
    table re-faults such an access for as long as the demoter keeps
    evicting its rows between its fault-in and its re-check) and with
    the values an all-warm table gives."""
    n = 3000
    t = _table(tmp_path, warm_rows=8, demote_interval=0.001)
    try:
        keys = np.arange(n)
        base = t.pull(keys).copy()
        W.wait_for(lambda: t.warm_resident_bytes() <= 8 * ROW,
                   what="background demotion under budget")
        before = t.stats()["cold_faults"]
        out, faults = t.pull_ex(keys)
        assert 0 < faults <= n
        assert t.stats()["cold_faults"] - before == faults
        np.testing.assert_array_equal(out, base)
        W.wait_for(lambda: t.warm_resident_bytes() <= 8 * ROW,
                   what="background demotion under budget")
        before = t.stats()["cold_faults"]
        t.push(keys, np.ones((n, DIM), np.float32), lr=0.5)
        np.testing.assert_array_equal(t.rows_for(keys), base - 0.5)
        assert t.stats()["cold_faults"] - before <= 2 * n
        assert not t._pinned
    finally:
        t.close()


class _HeldStore:
    """A chunk store whose reads on the thread named `held` signal
    `waiting`, then wait for `go`."""

    def __init__(self, store, go, waiting):
        self._store, self._go, self._waiting = store, go, waiting

    def __getattr__(self, name):
        return getattr(self._store, name)

    def read_rows(self, ent, lo, hi):
        if threading.current_thread().name == "held":
            self._waiting.set()
            self._go.wait(30)
        return self._store.read_rows(ent, lo, hi)


def test_concurrent_faulting_accesses_pin_only_their_own_rows(tmp_path):
    """Three accesses fault cold rows in at once while the background
    demoter runs, one of them held inside its cold read: the rows the
    other two fault in stay demotable, so warm bytes come back under
    the budget while the held access is still faulting. Every pull
    returns the rows an all-warm table gives, and no pin outlives its
    access."""
    n, budget = 1200, 8 * ROW
    go, waiting = threading.Event(), threading.Event()
    t = TieredTable(DIM, seed=7, store=_HeldStore(_store(tmp_path), go,
                                                  waiting),
                    name="t", warm_bytes=budget, demote_interval=0.002)
    errors = []

    def pull(keys):
        try:
            np.testing.assert_array_equal(t.pull(keys), base[keys])
        except BaseException as e:
            errors.append(e)

    try:
        base = t.pull(np.arange(n)).copy()
        W.wait_for(lambda: t.warm_resident_bytes() <= budget,
                   what="background demotion under budget")
        with t._lock:
            cold = np.asarray(sorted(t._cold), np.int64)
        held = threading.Thread(target=pull, args=(cold[:200],),
                                name="held")
        held.start()
        assert waiting.wait(15)
        rng = np.random.RandomState(3)

        def tails():
            for _ in range(20):
                pull(rng.choice(cold[200:], 60, replace=False))

        others = [threading.Thread(target=tails) for _ in range(2)]
        for th in others:
            th.start()
        for th in others:
            th.join(60)
        assert held.is_alive()
        W.wait_for(lambda: t.warm_resident_bytes() <= budget,
                   what="warm bytes under budget beside a held access")
        assert t.stats()["cold_faults"] > 0
        go.set()
        held.join(60)
        assert not held.is_alive() and not errors, errors
        W.wait_for(lambda: t.warm_resident_bytes() <= budget,
                   what="background demotion under budget")
        assert not t._pinned
    finally:
        go.set()
        t.close()


def test_export_import_round_trip_lands_warm(tmp_path):
    t = _table(tmp_path, warm_rows=4)
    t.pull(np.arange(24))
    t.push(np.arange(12), np.ones((12, DIM), np.float32))
    t.drain()
    want, _ = _state_dict(t)
    t2 = _table(tmp_path, warm_rows=4)
    t2.import_state(t.export_state())
    got, _ = _state_dict(t2)
    assert set(want) == set(got)
    for k in want:
        assert np.array_equal(want[k], got[k])
    assert t2.stats()["cold_rows"] == 0
    np.testing.assert_array_equal(t.pull([900, 901]), t2.pull([900, 901]))


# ---------------------------------------------------------------------------
# bitwise parity vs an all-warm LargeScaleKV, and vs the reference's
# TieredTable
# ---------------------------------------------------------------------------

def _interleave(tables, steps=150, demote_every=10, keep=None):
    r = np.random.default_rng(3)
    for step in range(steps):
        ids = r.integers(0, 200, size=r.integers(1, 9))
        if step % 3 == 2:
            g = r.normal(size=(len(ids), DIM)).astype(np.float32)
            for t in tables:
                t.push(ids, g, lr=0.1)
        else:
            outs = [t.pull(ids) for t in tables]
            for o in outs[1:]:
                np.testing.assert_array_equal(outs[0], o)
        if step % demote_every == 0:
            for t in tables:
                if hasattr(t, "demote"):
                    t.demote()
        if keep is not None:
            keep(step, tables)


def test_bitwise_parity_random_interleaving(tmp_path, numpy_kv):
    ref = LargeScaleKV(DIM, seed=7)
    t = _table(tmp_path, warm_rows=6)
    _interleave([ref, t])
    _assert_same(ref, t)
    np.testing.assert_array_equal(ref.pull([5000, 5001]),
                                  t.pull([5000, 5001]))


def test_export_state_equals_the_reference_tiered_table(tmp_path,
                                                        numpy_kv):
    """The port's TieredTable and the JAX package's, fed the same
    pulls, pushes and demotions, export the same keys (same order), rows
    and RNG stream, hold the same rows warm and cold, and count the same
    faults and demotions."""
    port = _table(tmp_path, warm_rows=6)
    ref = ref_ts.TieredTable(DIM, seed=7,
                             store=RefStore(str(tmp_path / "r"), keep=0),
                             name="t", warm_bytes=6 * ROW)

    def same_tiers(step, tables):
        if step % 25 == 0:
            a, b = tables
            assert set(a._index) == set(b._index)
            assert a._cold.keys() == b._cold.keys()

    _interleave([port, ref], keep=same_tiers)
    a, b = port.export_state(), ref.export_state()
    np.testing.assert_array_equal(a["keys"], b["keys"])
    np.testing.assert_array_equal(a["rows"], b["rows"])
    assert a["rng"]["pos"] == b["rng"]["pos"]
    np.testing.assert_array_equal(a["rng"]["key"], b["rng"]["key"])
    assert port.stats() == ref.stats()


def test_apply_rows_admits_cold_without_rng(tmp_path):
    t = _table(tmp_path, warm_rows=4)
    t.pull(np.arange(16))
    t.drain()
    pos0 = t.export_state()["rng"]["pos"]
    rows = np.full((16, DIM), 3.25, np.float32)
    t.apply_rows(np.arange(16), rows)
    assert t.export_state()["rng"]["pos"] == pos0
    np.testing.assert_array_equal(t.pull(np.arange(16)), rows)


# ---------------------------------------------------------------------------
# cold-read faults: contained to the faulting pull
# ---------------------------------------------------------------------------

def test_cold_fault_error_fails_one_pull_only(tmp_path):
    t = _table(tmp_path, warm_rows=4)
    t.pull(np.arange(16))
    t.drain()
    fi.injector().set_cold_fault("error", table="t", row="0")
    with pytest.raises(ColdReadError):
        t.pull([0])
    assert t.stats()["cold_read_errors"] == 1
    assert t.pull([0]).shape == (1, DIM)


def test_cold_fault_delay_slows_not_fails(tmp_path):
    t = _table(tmp_path, warm_rows=4)
    base = t.pull(np.arange(16)).copy()
    t.drain()
    fi.injector().set_cold_fault("delay", table="t", delay=0.2)
    t0 = time.perf_counter()
    out = t.pull(np.arange(16))
    assert time.perf_counter() - t0 >= 0.2
    np.testing.assert_array_equal(out, base)
    assert t.stats()["cold_read_errors"] == 0


def test_cold_fault_error_does_not_wedge_server(tmp_path):
    """A cold-read error fails only the faulting RPC: one remote error,
    and the shard serves every other request."""
    srv = PSServer("127.0.0.1:0", wal=True,
                   snapshot_dir=str(tmp_path / "snap"),
                   tier_warm_bytes=4 * ROW,
                   tier_store_dir=str(tmp_path / "store"))
    srv.serve_in_thread()
    cl = PSClient([srv.endpoint])
    try:
        cl.pull("emb", DIM, np.arange(16))
        srv.tables["emb"].drain()
        assert srv.tables["emb"].stats()["cold_rows"] > 0
        fi.injector().set_cold_fault("error", table="emb", row="0")
        raw = rpc.RpcClient(srv.endpoint, timeout=5.0, deadline=6.0,
                            max_retries=0)
        with pytest.raises(rpc.PSRemoteError, match="cold_read_failed"):
            raw.call({"op": "pull", "table": "emb", "dim": DIM,
                      "keys": np.asarray([0], np.int64)})
        raw.close()
        assert cl.pull("emb", DIM, [0]).shape == (1, DIM)
        cl.push("emb", DIM, [1], np.ones((1, DIM), np.float32))
    finally:
        cl.close()
        _stop(srv)


def test_fault_knobs_parse_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_PS_FAULT_COLD_ACTION", "delay")
    monkeypatch.setenv("PADDLE_PS_FAULT_COLD_TABLE", "emb")
    monkeypatch.setenv("PADDLE_PS_FAULT_COLD_ROW", "17")
    monkeypatch.setenv("PADDLE_PS_FAULT_COLD_DELAY", "0.05")
    inj = fi.FaultInjector.from_env()
    assert inj.active
    assert inj.cold_fault("emb", [17]) == ("delay", 0.05)
    assert inj.cold_fault("emb", [17]) is None  # one-shot


# ---------------------------------------------------------------------------
# PSServer integration: WAL restart, HA failover, handoff
# ---------------------------------------------------------------------------

def _drive(cl, steps=60, seed=11):
    r = np.random.default_rng(seed)
    for _ in range(steps):
        ids = r.integers(0, 300, size=8)
        v = cl.pull("emb", DIM, ids)
        cl.push("emb", DIM, ids, 0.1 * v)


def test_wal_restart_parity_tiered_vs_all_warm(tmp_path, numpy_kv):
    """The same history through a tiered shard and an all-warm one,
    both killed and restored from snapshot + WAL: identical tables and
    the same next lazy-init draw."""
    tiered = PSServer("127.0.0.1:0", wal=True,
                      snapshot_dir=str(tmp_path / "a"),
                      tier_warm_bytes=8 * ROW,
                      tier_store_dir=str(tmp_path / "a_store"))
    plain = PSServer("127.0.0.1:0", wal=True,
                     snapshot_dir=str(tmp_path / "b"))
    tiered.serve_in_thread()
    plain.serve_in_thread()
    c1, c2 = PSClient([tiered.endpoint]), PSClient([plain.endpoint])
    _drive(c1)
    _drive(c2)
    tiered.tables["emb"].drain()
    assert tiered.tables["emb"].stats()["cold_rows"] > 0
    assert c1.cold_faults > 0
    ep_a, ep_b = tiered.endpoint, plain.endpoint
    tiered.kill()
    plain.kill()
    ra = PSServer.restart_from_snapshot(
        ep_a, str(tmp_path / "a"), wal=True, tier_warm_bytes=8 * ROW,
        tier_store_dir=str(tmp_path / "a_store"))
    rb = PSServer.restart_from_snapshot(ep_b, str(tmp_path / "b"),
                                        wal=True)
    try:
        ra.serve_in_thread()
        rb.serve_in_thread()
        assert isinstance(ra.tables["emb"], TieredTable)
        _assert_same(ra.tables["emb"], rb.tables["emb"])
        np.testing.assert_array_equal(ra.tables["emb"].pull([7777]),
                                      rb.tables["emb"].pull([7777]))
    finally:
        c1.close()
        c2.close()
        _stop(ra, rb)


def test_ha_failover_with_cold_resident_rows(tmp_path, numpy_kv):
    """Kill the primary while part of its table is cold: the promoted
    standby holds every row bitwise equal to an all-warm shard fed the
    same history, and draws the same lazy rows."""
    tier_kw = dict(tier_warm_bytes=8 * ROW)
    prim = PSServer("127.0.0.1:0", wal=True,
                    snapshot_dir=str(tmp_path / "p"),
                    tier_store_dir=str(tmp_path / "p_store"), **tier_kw)
    prim.serve_in_thread()
    stby = PSServer("127.0.0.1:0", wal=True,
                    snapshot_dir=str(tmp_path / "s"),
                    primary=prim.endpoint,
                    tier_store_dir=str(tmp_path / "s_store"), **tier_kw)
    stby.serve_in_thread()
    ref = PSServer("127.0.0.1:0", wal=True,
                   snapshot_dir=str(tmp_path / "r"))
    ref.serve_in_thread()
    cl, cr = PSClient([prim.endpoint]), PSClient([ref.endpoint])
    try:
        W.wait_for(lambda: stby._ha_replicator.synced.is_set(),
                   what="standby bootstrap")
        _drive(cl)
        _drive(cr)
        prim.tables["emb"].drain()
        assert prim.tables["emb"].stats()["cold_rows"] > 0
        W.wait_for(lambda: (stby._ha_replicator.applied_seq
                            >= prim._ha.seq), what="standby caught up")
        prim.kill()
        stby.promote(prim.shard_epoch + 1)
        _assert_same(stby.tables["emb"], ref.tables["emb"])
        grp = PSClient([prim.endpoint + "|" + stby.endpoint])
        np.testing.assert_array_equal(grp.pull("emb", DIM, [8888, 8889]),
                                      cr.pull("emb", DIM, [8888, 8889]))
        grp.close()
    finally:
        cl.close()
        cr.close()
        _stop(stby, ref)
        prim.server_close()


def test_tiered_handoff_zero_failed_pushes(tmp_path, numpy_kv):
    """ha_handoff of a tiered primary under live pushes: none fails,
    each applies once, and the new primary's tier stays under budget."""
    kw = dict(wal=True, tier_warm_bytes=8 * ROW)
    prim = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "p"),
                    tier_store_dir=str(tmp_path / "p_store"), **kw)
    prim.serve_in_thread()
    stby = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "s"),
                    primary=prim.endpoint,
                    tier_store_dir=str(tmp_path / "s_store"), **kw)
    stby.serve_in_thread()
    cl = PSClient([f"{prim.endpoint}|{stby.endpoint}"], deadline=60.0,
                  backoff=0.02)
    errs: list = []
    n = 60
    handoff_at = threading.Event()

    def pusher():
        try:
            for k in range(n):
                cl.push("t", DIM, [0], np.ones((1, DIM)), lr=1.0)
                if k == 15:
                    handoff_at.set()
        except Exception as e:              # pragma: no cover
            errs.append(e)

    try:
        base = cl.pull("t", DIM, [0]).copy()
        cl.pull("t", DIM, np.arange(64))
        prim.tables["t"].drain()
        W.wait_for(lambda: (stby._ha_replicator.synced.is_set()
                            and stby._ha_replicator.applied_seq
                            >= prim._ha.seq), what="standby catch-up")
        th = threading.Thread(target=pusher)
        th.start()
        assert handoff_at.wait(timeout=60)
        ctl = rpc.RpcClient(prim.endpoint, timeout=60.0, deadline=90.0,
                            max_retries=0)
        rep = ctl.call({"op": "ha_handoff", "target": stby.endpoint},
                       timeout=60.0)
        ctl.close()
        assert rep["promoted"] == stby.endpoint
        th.join(timeout=120)
        assert not th.is_alive(), "pusher hung across handoff"
        assert not errs, errs
        np.testing.assert_allclose(base - cl.pull("t", DIM, [0]),
                                   float(n), rtol=1e-6)
        assert stby.ha_role == "primary"
        assert isinstance(stby.tables["t"], TieredTable)
        stby.tables["t"].drain()
        assert stby.tables["t"].warm_resident_bytes() <= 8 * ROW
    finally:
        cl.close()
        _stop(prim, stby)


# ---------------------------------------------------------------------------
# chunk GC, metrics, env knobs, thread shutdown
# ---------------------------------------------------------------------------

def test_gc_cold_store_drops_dead_chunks_only(tmp_path):
    t = _table(tmp_path, warm_rows=4)
    t.push(np.arange(32), np.ones((32, DIM), np.float32))
    t.drain()
    for _ in range(4):
        t.push(np.arange(32), np.ones((32, DIM), np.float32))
        t.drain()
    store = t._store
    dead = len(store.chunks.all_digests())
    removed = gc_cold_store(store, [t], min_age=0.0)
    assert removed > 0
    assert len(store.chunks.all_digests()) == dead - removed
    want, _ = _state_dict(t)
    for k, r in zip(np.arange(32), t.pull(np.arange(32))):
        assert np.array_equal(want[int(k)], r)
    t.push(np.arange(32), np.ones((32, DIM), np.float32))
    t.drain()
    assert gc_cold_store(store, [t], min_age=3600.0) == 0


def test_tier_metrics_registered():
    from paddle_tpu_torch.observability.registry import REGISTRY
    for name in ("paddle_tpu_ps_tier_hits_total",
                 "paddle_tpu_ps_tier_misses_total",
                 "paddle_tpu_ps_tier_resident_rows",
                 "paddle_tpu_ps_tier_resident_bytes",
                 "paddle_tpu_ps_tier_faults_total",
                 "paddle_tpu_ps_tier_demotions_total",
                 "paddle_tpu_ps_tier_cold_read_errors_total",
                 "paddle_tpu_ps_tier_pull_seconds"):
        assert REGISTRY.get(name) is not None, name


def test_env_knob_config(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_PS_TIER_WARM_BYTES", str(8 * ROW))
    monkeypatch.setenv("PADDLE_PS_TIER_STORE_DIR", str(tmp_path / "store"))
    monkeypatch.setenv("PADDLE_PS_TIER_TABLES", "emb,wide")
    srv = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "snap"))
    srv.serve_in_thread()
    try:
        assert isinstance(srv.table("emb", DIM), TieredTable)
        assert isinstance(srv.table("wide", DIM), TieredTable)
        assert not isinstance(srv.table("other", DIM), TieredTable)
    finally:
        _stop(srv)


def test_server_close_stops_demoter_and_replicator_threads(tmp_path,
                                                           numpy_kv):
    """No tier or HA thread outlives its shard: server_close and kill()
    stop the demoters and the standby's replicator."""
    def ours():
        return {t for t in threading.enumerate()
                if t.name.startswith(("ps-tier-demote", "ps-ha-"))}

    before = ours()
    kw = dict(wal=True, tier_warm_bytes=4 * ROW)
    prim = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "p"), **kw)
    prim.serve_in_thread()
    stby = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "s"),
                    primary=prim.endpoint, **kw)
    stby.serve_in_thread()
    cl = PSClient([prim.endpoint])
    cl.pull("emb", DIM, np.arange(32))
    W.wait_for(lambda: stby._ha_replicator.applied_seq >= prim._ha.seq,
               what="standby caught up")
    assert len(ours() - before) >= 3
    cl.close()
    stby.kill()
    prim.kill()
    W.wait_for(lambda: not (ours() - before), timeout=15.0,
               what="tier and HA threads to stop")


# ---------------------------------------------------------------------------
# the chip run's tiered worker, in processes, at a tiny size on the CPU
# ---------------------------------------------------------------------------

def test_downpour_worker_over_a_mostly_cold_table(tmp_path):
    """ps_roles.tier_run as the chip run drives it: a Downpour worker
    process (tiny config, CPU) over two shards, all-warm, then with
    embed tiered under 1/8 of the embed bytes each shard held: cold
    faults and demotions happen, and losses and every touched row and
    dense table are bit equal."""
    run = ps_roles.Runner(str(tmp_path / "runner.log"), DEVICE="cpu",
                          CONFIG="tiny", BATCH=64, WARMUP=1, STEPS=6)
    try:
        warm = ps_roles.tier_run(run, str(tmp_path), "warm")
        dim = 8  # WideDeepConfig.tiny().embed_dim
        budgets = [s["embed_rows"] * dim * 4 // 8 for s in warm["shards"]]
        tiered = ps_roles.tier_run(run, str(tmp_path), "tiered",
                                   budgets=budgets)
    finally:
        run.close()
    assert tiered["line"]["cold_faults"] > 0
    assert sum(s["cold_faults"] for s in tiered["shards"]) > 0
    assert sum(s["demoted_clean"] + s["demoted_flush"]
               for s in tiered["shards"]) > 0
    assert all(s["cold_read_errors"] == 0 for s in tiered["shards"])
    assert [s["embed_rows"] for s in tiered["shards"]] == \
        [s["embed_rows"] for s in warm["shards"]]
    assert tiered["line"]["losses"] == warm["line"]["losses"]
    for k, v in warm["tables"].items():
        np.testing.assert_array_equal(tiered["tables"][k], v, err_msg=k)
