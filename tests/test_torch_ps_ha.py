"""The port's PS high availability
(paddle_tpu_torch/distributed/fleet/runtime/ps_ha.py and its PSServer /
PSClient hooks) against the JAX package's: live WAL replication to hot
standbys, semi-sync acks, epoch fencing, promotion, planned handoff,
replication faults, a standby killed at a record, the chaos drill of a
primary killed mid-push, standbys of one package replicating from
primaries of the other with a failover onto each, and a Downpour worker
riding through a primary kill in processes (the chip run's drill at a
tiny size)."""
import os
import threading
import time

import numpy as np
import pytest

import torch_ps_workers as W
from paddle_tpu.distributed.fleet.runtime import \
    parameter_server_runtime as ref_ps
from paddle_tpu.distributed.fleet.runtime import ps_ha as ref_ha
from paddle_tpu_torch.distributed.fleet import ps_roles
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.distributed.fleet.runtime import \
    parameter_server_runtime as ps
from paddle_tpu_torch.distributed.fleet.runtime import ps_ha
from paddle_tpu_torch.distributed.fleet.runtime import rpc
from paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime \
    import PSClient, PSServer
from paddle_tpu_torch.distributed.fleet.runtime.ps_ha import promote_best

PKGS = {"port": ps, "ref": ref_ps}
HA = {"port": ps_ha, "ref": ref_ha}


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


@pytest.fixture
def numpy_kv(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")


def _primary(tmp_path, name="prim", mod=ps, **kw):
    d = str(tmp_path / name)
    os.makedirs(d, exist_ok=True)
    srv = mod.PSServer("127.0.0.1:0", snapshot_dir=d, wal=True, **kw)
    srv.serve_in_thread()
    return srv


def _standby(primary, tmp_path, name="stby", mod=ps, **kw):
    d = str(tmp_path / name)
    os.makedirs(d, exist_ok=True)
    srv = mod.PSServer("127.0.0.1:0", snapshot_dir=d, wal=True,
                       primary=primary.endpoint, **kw)
    srv.serve_in_thread()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _tables_equal(a, b):
    if set(a.tables) != set(b.tables):
        return False
    for n, t in a.tables.items():
        sa, sb = t.export_state(), b.tables[n].export_state()
        if not np.array_equal(sa["keys"], sb["keys"]):
            return False
        if not np.array_equal(sa["rows"], sb["rows"]):
            return False
    return True


def _synced(prim, stby):
    rep = stby._ha_replicator
    return (rep is not None and rep.synced.is_set()
            and rep.applied_seq >= prim._ha.seq
            and _tables_equal(prim, stby))


# ---------------------------------------------------------------------------
# live replication: the standby tracks the primary row for row
# ---------------------------------------------------------------------------

def test_standby_tracks_primary_row_for_row(tmp_path, numpy_kv):
    """Every committed WAL record (rows + request id + RNG-consuming
    lazy inits) replays on the standby: tables, RNG streams and the
    dedup cache are identical once the lag drains."""
    prim = _primary(tmp_path)
    stby = _standby(prim, tmp_path)
    cl = PSClient([prim.endpoint])
    try:
        rng = np.random.RandomState(3)
        cl.push("emb", 8, np.arange(40), rng.randn(40, 8))
        cl.pull("emb", 8, [2, 777])        # 777: lazy init, burns RNG
        cl.push("emb", 8, [3, 9], rng.randn(2, 8))
        cl.push("wide", 4, [5], rng.randn(1, 4))
        W.wait_for(lambda: _synced(prim, stby), what="standby catch-up")
        for n, t in prim.tables.items():
            a = t.export_state()
            b = stby.tables[n].export_state()
            np.testing.assert_array_equal(a["keys"], b["keys"])
            np.testing.assert_array_equal(a["rows"], b["rows"])
            assert a["rng"]["pos"] == b["rng"]["pos"]
            np.testing.assert_array_equal(a["rng"]["key"], b["rng"]["key"])
        assert len(stby._rpc.dedup._order) == \
            len(prim._rpc.dedup._order) > 0
        np.testing.assert_array_equal(
            prim.tables["emb"].pull(np.array([888])),
            stby.tables["emb"].pull(np.array([888])))
        W.wait_for(lambda: all(s["lag_rows"] == 0
                               for s in prim._ha.status()),
                   what="lag drain")
        assert stby.ha_status()["synced"]
    finally:
        cl.close()
        _stop(stby)
        _stop(prim)


def test_standby_redirects_data_plane_ops(tmp_path):
    """A standby answers only the control plane; pushes and pulls get a
    not_primary redirect naming the primary and epoch."""
    prim = _primary(tmp_path)
    stby = _standby(prim, tmp_path)
    try:
        cl = rpc.RpcClient(stby.endpoint, deadline=5.0, max_retries=0)
        with pytest.raises(rpc.PSRemoteError,
                           match="not_primary primary="):
            cl.call({"op": "pull", "table": "t", "dim": 4,
                     "keys": np.array([1], np.int64)})
        st = cl.call({"op": "ha_status"})
        assert st["role"] == "standby" and st["primary"] == prim.endpoint
        cl.close()
    finally:
        _stop(stby)
        _stop(prim)


def test_replication_survives_journal_rotation(tmp_path, numpy_kv):
    """A primary-side WAL compaction ships a rotate marker; the standby
    re-anchors and keeps tracking — no resync, no divergence."""
    prim = _primary(tmp_path)
    prim.wal_compact_bytes = 1200
    stby = _standby(prim, tmp_path)
    cl = PSClient([prim.endpoint])
    try:
        for i in range(30):
            cl.push("t", 4, [i % 7], np.ones((1, 4)))
        assert prim.full_snapshots >= 1
        W.wait_for(lambda: _synced(prim, stby), what="post-rotate sync")
        assert stby._ha_replicator.resyncs == 0
    finally:
        cl.close()
        _stop(stby)
        _stop(prim)


# ---------------------------------------------------------------------------
# ack modes
# ---------------------------------------------------------------------------

def test_semisync_acks_with_live_standby_and_degrades(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("PADDLE_PS_HA_SEMISYNC", "1")
    monkeypatch.setenv("PADDLE_PS_HA_SEMISYNC_TIMEOUT", "1.0")
    prim = _primary(tmp_path)
    stby = _standby(prim, tmp_path)
    cl = PSClient([prim.endpoint])
    try:
        assert prim._ha.semisync == 1
        W.wait_for(lambda: stby._ha_replicator.synced.is_set(),
                   what="standby bootstrap")
        for _ in range(5):
            cl.push("t", 4, [1], np.ones((1, 4)))
        assert prim._ha.degraded == 0
        W.wait_for(lambda: _synced(prim, stby), what="semisync catch-up")
        stby.kill()
        t0 = time.monotonic()
        cl.push("t", 4, [1], np.ones((1, 4)))
        assert prim._ha.degraded >= 1
        assert time.monotonic() - t0 < 10.0
        assert prim.ha_status()["semisync_degraded"] >= 1
    finally:
        cl.close()
        _stop(stby)
        _stop(prim)


# ---------------------------------------------------------------------------
# epoch fencing
# ---------------------------------------------------------------------------

def test_zombie_primary_fences_itself(tmp_path, numpy_kv):
    """A partitioned ex-primary that sees one request with a newer
    epoch fences for good; a group client rides the stale_epoch answer
    to the successor."""
    prim = _primary(tmp_path, ha_epoch=1)
    stby = _standby(prim, tmp_path)
    try:
        seed = PSClient([prim.endpoint])
        seed.push("t", 4, [0], np.ones((1, 4)))
        W.wait_for(lambda: _synced(prim, stby), what="standby catch-up")
        seed.close()
        assert promote_best([stby.endpoint], epoch=2) == stby.endpoint
        direct = rpc.RpcClient(prim.endpoint, deadline=5.0, max_retries=0)
        push = {"op": "push", "table": "t", "dim": 4,
                "keys": np.array([0], np.int64),
                "grads": np.ones((1, 4), np.float32), "lr": 1.0}
        with pytest.raises(rpc.PSRemoteError, match="stale_epoch"):
            direct.call(dict(push, _epoch=2))
        assert prim._ha_fenced
        with pytest.raises(rpc.PSRemoteError, match="stale_epoch"):
            direct.call(dict(push))
        direct.close()
        cl = PSClient([f"{prim.endpoint}|{stby.endpoint}"],
                      deadline=30.0, backoff=0.02)
        cl.push("t", 4, [0], np.ones((1, 4)))
        assert cl.fenced_rejects >= 1 and cl.failovers == 1
        assert cl.endpoints[0] == stby.endpoint
        np.testing.assert_allclose(
            stby.tables["t"].export_state()["rows"][0].sum(),
            prim.tables["t"].export_state()["rows"][0].sum() - 4.0,
            rtol=1e-6)
        cl.close()
    finally:
        _stop(stby)
        _stop(prim)


# ---------------------------------------------------------------------------
# chaos drill: kill the primary mid-push under concurrent pushes, live
# reads and an invalidation subscription
# ---------------------------------------------------------------------------

def test_chaos_kill_primary_mid_push_bit_for_bit(tmp_path, numpy_kv,
                                                 monkeypatch):
    dim, n_workers, n_pushes = 4, 3, 30
    rngs = [np.random.RandomState(100 + w) for w in range(n_workers)]
    grads = [[rngs[w].randn(2, dim).astype(np.float32)
              for _ in range(n_pushes)] for w in range(n_workers)]

    def seed_tables(cl):
        for w in range(n_workers):
            cl.push(f"t{w}", dim, np.arange(10),
                    np.zeros((10, dim), np.float32))

    def worker(cl, w, errs):
        try:
            for k in range(n_pushes):
                cl.push(f"t{w}", dim, [k % 10, (k * 3 + 1) % 10],
                        grads[w][k], lr=1.0)
        except Exception as e:              # pragma: no cover
            errs.append(e)

    def collect(cl):
        return [cl.pull(f"t{w}", dim, np.arange(10)).copy()
                for w in range(n_workers)]

    ref_srv = PSServer("127.0.0.1:0")
    ref_srv.serve_in_thread()
    ref_cl = PSClient([ref_srv.endpoint])
    seed_tables(ref_cl)
    for w in range(n_workers):
        worker(ref_cl, w, [])
    ref = collect(ref_cl)
    ref_cl.close()
    _stop(ref_srv)

    monkeypatch.setenv("PADDLE_PS_HA_SEMISYNC", "1")
    monkeypatch.setenv("PADDLE_PS_HA_SEMISYNC_TIMEOUT", "10.0")
    prim = _primary(tmp_path)
    stby = _standby(prim, tmp_path)
    cl = PSClient([f"{prim.endpoint}|{stby.endpoint}"], deadline=60.0,
                  backoff=0.02)
    inval_events: list = []
    inval_stop = cl.subscribe_invalidations(
        lambda table, keys: inval_events.append(table))
    serve_errs: list = []
    push_errs: list = []
    stop_serving = threading.Event()

    def serving():
        while not stop_serving.is_set():
            try:
                cl.pull("t0", dim, np.arange(10))
            except Exception as e:          # pragma: no cover
                serve_errs.append(e)
                return
            time.sleep(0.002)

    try:
        W.wait_for(lambda: len(prim._ha.status()) > 0,
                   what="standby attach")
        seed_tables(cl)
        W.wait_for(lambda: _synced(prim, stby), what="standby seed sync")
        base_degraded = prim._ha.degraded
        server_thread = threading.Thread(target=serving)
        server_thread.start()
        threads = [threading.Thread(target=worker, args=(cl, w, push_errs))
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        W.wait_for(lambda: prim._mutations > 25, what="pushes in flight")
        degraded_before_kill = prim._ha.degraded
        prim.kill()
        assert promote_best([stby.endpoint], epoch=2) == stby.endpoint
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "push hang"
        stop_serving.set()
        server_thread.join(timeout=30)
        assert not push_errs, push_errs
        assert not serve_errs, serve_errs
        assert degraded_before_kill == base_degraded
        assert cl.failovers >= 1
        assert stby.ha_role == "primary" and stby.shard_epoch == 2
        assert inval_events, "invalidation stream saw no pushes"
        final = collect(cl)
        for w in range(n_workers):
            np.testing.assert_array_equal(
                ref[w], final[w],
                err_msg=f"t{w} diverged — exactly-once violated across "
                        "failover")
    finally:
        stop_serving.set()
        inval_stop.set()
        cl.close()
        _stop(stby)
        _stop(prim)


# ---------------------------------------------------------------------------
# planned handoff
# ---------------------------------------------------------------------------

def test_planned_handoff_zero_failed_pushes(tmp_path, numpy_kv):
    prim = _primary(tmp_path)
    stby = _standby(prim, tmp_path)
    cl = PSClient([f"{prim.endpoint}|{stby.endpoint}"], deadline=60.0,
                  backoff=0.02)
    errs: list = []
    n = 60
    handoff_at = threading.Event()

    def pusher():
        try:
            for k in range(n):
                cl.push("t", 4, [0], np.ones((1, 4)), lr=1.0)
                if k == 15:
                    handoff_at.set()
        except Exception as e:              # pragma: no cover
            errs.append(e)

    try:
        base = cl.pull("t", 4, [0]).copy()
        W.wait_for(lambda: _synced(prim, stby), what="standby catch-up")
        th = threading.Thread(target=pusher)
        th.start()
        assert handoff_at.wait(timeout=60)
        ctl = rpc.RpcClient(prim.endpoint, timeout=60.0, deadline=90.0,
                            max_retries=0)
        rep = ctl.call({"op": "ha_handoff", "target": stby.endpoint},
                       timeout=60.0)
        ctl.close()
        assert rep["promoted"] == stby.endpoint and rep["epoch"] == 1
        th.join(timeout=120)
        assert not th.is_alive(), "pusher hung across handoff"
        assert not errs, errs
        np.testing.assert_allclose(base - cl.pull("t", 4, [0]), float(n),
                                   rtol=1e-6)
        assert cl.redirects >= 1
        assert stby.ha_role == "primary" and prim.ha_role == "standby"
        assert prim.ha_primary == stby.endpoint
        W.wait_for(lambda: _synced(stby, prim), what="ex-primary re-sync")
    finally:
        cl.close()
        _stop(prim)
        _stop(stby)


# ---------------------------------------------------------------------------
# replication-stream faults: drop -> gap resync, corrupt -> CRC resync,
# delay -> lag only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", ["drop", "corrupt", "delay"])
def test_repl_fault_resyncs_standby(action, tmp_path, numpy_kv):
    prim = _primary(tmp_path)
    stby = _standby(prim, tmp_path)
    cl = PSClient([prim.endpoint])
    try:
        cl.push("t", 4, [0], np.ones((1, 4)))
        W.wait_for(lambda: _synced(prim, stby), what="standby catch-up")
        fi.injector().set_repl_fault(action, record="any", delay=0.3)
        cl.push("t", 4, [1], np.ones((1, 4)))   # the faulted record
        cl.push("t", 4, [2], np.ones((1, 4)))   # exposes a drop gap
        W.wait_for(lambda: _synced(prim, stby),
                   what=f"recovery from {action}", timeout=30.0)
        assert fi.injector().counters["repl_faults"] == 1
        rep = stby._ha_replicator
        if action == "delay":
            assert rep.resyncs == 0
        else:
            assert rep.resyncs >= 1 and stby.ha_status()["resyncs"] >= 1
    finally:
        cl.close()
        _stop(stby)
        _stop(prim)


# ---------------------------------------------------------------------------
# a standby process killed at its 3rd record, respawned, promoted
# ---------------------------------------------------------------------------

def test_kill_standby_at_record_subprocess(tmp_path, numpy_kv):
    prim = _primary(tmp_path)
    stby_ep = W.endpoint()
    env = dict(PADDLE_PS_SNAPSHOT_DIR=tmp_path / "stby_sub",
               PADDLE_PS_WAL="1", PADDLE_PS_HA_PRIMARY=prim.endpoint,
               PADDLE_TPU_DISABLE_NATIVE="1")
    procs = []
    cl = PSClient([prim.endpoint])
    try:
        p, ready = W.spawn_shard(stby_ep, PADDLE_PS_FAULT_KILL_AT_RECORD="3",
                                 **env)
        procs.append(p)
        assert ready["role"] == "standby" and ready["wal"]
        W.wait_for(lambda: len(prim._ha.status()) > 0,
                   what="subprocess standby attach")
        rng = np.random.RandomState(0)
        for i in range(6):
            cl.push("t", 4, [i], rng.randn(1, 4))
        assert p.wait(timeout=60) == fi.KILL_EXIT_CODE
        want = cl.pull("t", 4, np.arange(6)).copy()
        p2, _ = W.spawn_shard(stby_ep, **env)
        procs.append(p2)

        def caught_up():
            try:
                st = ps_roles.ha_status(stby_ep)
            except Exception:
                return False
            return st.get("synced") \
                and st.get("applied_seq", -1) >= prim._ha.seq
        W.wait_for(caught_up, timeout=30.0, what="respawned standby sync")
        ctl = rpc.RpcClient(stby_ep, deadline=10.0, max_retries=1)
        st = ctl.call({"op": "ha_promote", "epoch": 2}, timeout=5.0)
        ctl.close()
        assert st["role"] == "primary" and st["epoch"] == 2
        cl2 = PSClient([stby_ep])
        np.testing.assert_array_equal(cl2.pull("t", 4, np.arange(6)), want)
        cl2.close()
    finally:
        cl.close()
        W.stop(procs)
        _stop(prim)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_record_crc_matches_the_reference():
    rng = np.random.RandomState(1)
    for shape in ((0, 4), (3, 8), (17, 1)):
        v = rng.randn(*shape).astype(np.float32)
        assert ps_ha.record_crc(v) == ref_ha.record_crc(v)
    assert ps_ha.record_crc(np.arange(6, dtype=np.float64)) == \
        ref_ha.record_crc(np.arange(6, dtype=np.float64))


@pytest.mark.parametrize("prim_pkg,stby_pkg",
                         [("ref", "port"), ("port", "ref")])
def test_standby_of_the_other_package_tracks_and_takes_over(
        prim_pkg, stby_pkg, tmp_path, numpy_kv, monkeypatch):
    """A standby of one package replicating from a primary of the other
    under semi-sync: tables, RNG streams and dedup ids equal after the
    drain; the primary dies, the standby's package promotes it, and a
    group client of the standby's package pushes on through it, bit
    equal to a fault-free reference shard fed the same requests."""
    monkeypatch.setenv("PADDLE_PS_HA_SEMISYNC", "1")
    monkeypatch.setenv("PADDLE_PS_HA_SEMISYNC_TIMEOUT", "10.0")
    prim = _primary(tmp_path, mod=PKGS[prim_pkg])
    stby = _standby(prim, tmp_path, mod=PKGS[stby_pkg])
    solo = PKGS[prim_pkg].PSServer("127.0.0.1:0")
    solo.serve_in_thread()
    cl = PKGS[stby_pkg].PSClient([f"{prim.endpoint}|{stby.endpoint}"],
                                 deadline=30.0, backoff=0.02)
    cs = PKGS[stby_pkg].PSClient([solo.endpoint])
    try:
        W.wait_for(lambda: len(prim._ha.status()) > 0,
                   what="standby attach")
        rng = np.random.RandomState(9)
        for i in range(12):
            keys = [i % 5, (i * 3) % 11]
            g = rng.randn(2, 4)
            for c in (cl, cs):
                c.push("emb", 4, keys, g, lr=0.5)
            if i == 6:
                for c in (cl, cs):
                    c.pull("emb", 4, [300, 301])     # lazy inits
        W.wait_for(lambda: _synced(prim, stby), what="standby catch-up")
        for n, t in prim.tables.items():
            a, b = t.export_state(), stby.tables[n].export_state()
            assert a["rng"]["pos"] == b["rng"]["pos"]
            np.testing.assert_array_equal(a["rng"]["key"], b["rng"]["key"])
        ids_p, blobs_p = prim._rpc.dedup.export()
        ids_s, blobs_s = stby._rpc.dedup.export()
        np.testing.assert_array_equal(ids_p, ids_s)
        assert blobs_p == blobs_s
        prim.kill()
        assert HA[stby_pkg].promote_best([stby.endpoint], 2) \
            == stby.endpoint
        for c in (cl, cs):
            c.push("emb", 4, [1, 400], np.ones((2, 4)), lr=0.5)
        assert cl.failovers >= 1 and cl.endpoints[0] == stby.endpoint
        keys = np.array([0, 1, 2, 3, 4, 5, 8, 300, 301, 400])
        np.testing.assert_array_equal(cl.pull("emb", 4, keys),
                                      cs.pull("emb", 4, keys))
    finally:
        cl.close()
        cs.close()
        for s in (stby, solo):
            _stop(s)
        prim.server_close()


def test_ha_metrics_registered():
    from paddle_tpu_torch.observability.registry import REGISTRY
    for name in ("paddle_tpu_ps_ha_role",
                 "paddle_tpu_ps_ha_epoch",
                 "paddle_tpu_ps_ha_standbys_connected",
                 "paddle_tpu_ps_ha_replication_lag_rows",
                 "paddle_tpu_ps_ha_replication_lag_bytes",
                 "paddle_tpu_ps_ha_replication_lag_seconds",
                 "paddle_tpu_ps_ha_records_shipped_total",
                 "paddle_tpu_ps_ha_semisync_total",
                 "paddle_tpu_ps_ha_fenced_writes_total",
                 "paddle_tpu_ps_ha_promotions_total",
                 "paddle_tpu_ps_ha_handoffs_total",
                 "paddle_tpu_ps_ha_resyncs_total"):
        assert REGISTRY.get(name) is not None, name


def test_ha_group_entry_binds_this_process_member(monkeypatch):
    """fleet's PS runtime binds the member of a ``primary|standby``
    entry named by PADDLE_CURRENT_ENDPOINT."""
    a, b = W.endpoint(), W.endpoint()
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", b)

    class Roles:
        def get_pserver_endpoints(self):
            return [f"{a}|{b}"]

        def server_index(self):
            return 0

    rt = ps.ParameterServerRuntime(Roles())
    rt.init_server()
    try:
        assert rt.server.endpoint == b
    finally:
        rt.server.server_close()


# ---------------------------------------------------------------------------
# the chip run's drill, in processes, at a tiny size on the CPU
# ---------------------------------------------------------------------------

def test_downpour_worker_rides_through_a_primary_kill(tmp_path):
    """ps_roles.ha_run as the chip run drives it: a Downpour worker
    process (tiny config, CPU) over two semi-sync HA groups, once
    fault-free and once with shard 0's primary killed after a commit
    and before its reply, at half the requests it received in the
    fault-free run, its standby promoted at epoch 2. Losses and every
    touched row and dense table are bit equal."""
    run = ps_roles.Runner(str(tmp_path / "runner.log"), DEVICE="cpu",
                          CONFIG="tiny", BATCH=64, WARMUP=1, STEPS=6)
    try:
        clean = ps_roles.ha_run(run, str(tmp_path), "clean")
        chaos = ps_roles.ha_run(run, str(tmp_path), "chaos",
                                kill_after=clean["requests"] // 2)
    finally:
        run.close()
    assert chaos["killed_code"] == fi.KILL_EXIT_CODE
    assert chaos["promoted"] == chaos["groups"][0].split("|")[1]
    assert chaos["standby_status"]["role"] == "primary"
    assert chaos["standby_status"]["epoch"] == 2
    assert chaos["line"]["failovers"] >= 1
    assert any(end > chaos["kill_t"] for _, end in chaos["line"]["pushes"])
    assert chaos["line"]["losses"] == clean["line"]["losses"]
    assert set(chaos["tables"]) == set(clean["tables"])
    for k, v in clean["tables"].items():
        np.testing.assert_array_equal(chaos["tables"][k], v, err_msg=k)
