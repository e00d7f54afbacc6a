"""The port's parameter-server tier (paddle_tpu_torch/distributed/fleet/
runtime/parameter_server_runtime.py, paddle_tpu_torch/native) against the
JAX package's: the KV core, the wire both ways, snapshots both ways, the
fleet PS lifecycle, the configurations left to later items, and a
Downpour run through frame corruption and a shard kill."""
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch_ps_workers as W
from paddle_tpu.distributed.fleet.runtime import \
    parameter_server_runtime as ref_ps
from paddle_tpu.distributed.fleet.runtime import rpc as ref_rpc
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.distributed.fleet.runtime import \
    parameter_server_runtime as ps
from paddle_tpu_torch.distributed.fleet.runtime import rpc

PKGS = {"port": ps, "ref": ref_ps}


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


@pytest.fixture(params=["native", "numpy"])
def kv_path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_DISABLE_NATIVE", raising=False)
    return request.param


def _serve(mod, ep="127.0.0.1:0", **kw):
    srv = mod.PSServer(ep, **kw)
    srv.serve_in_thread()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


# ---------------------------------------------------------------------------
# LargeScaleKV: the native core and the numpy path
# ---------------------------------------------------------------------------

def test_largescalekv_rows_bit_equal_to_the_reference(kv_path):
    keys = np.array([7, -1, 3, 7, 10 ** 12 + 5, -1, 0], np.int64)
    a = ps.LargeScaleKV(4, init_std=0.05, seed=11)
    b = ref_ps.LargeScaleKV(4, init_std=0.05, seed=11)
    assert (a._native is not None) == (kv_path == "native")
    assert (a._native is None) == (b._native is None)
    ra, rb = a.pull(keys), b.pull(keys)
    np.testing.assert_array_equal(ra, rb)
    # duplicate new keys in one batch allocate one row each
    assert a.size() == b.size() == 5
    np.testing.assert_array_equal(ra[0], ra[3])
    np.testing.assert_array_equal(ra[1], ra[5])
    # a push with duplicates accumulates, as the reference's
    g = np.arange(12, dtype=np.float32).reshape(3, 4)
    a.push(np.array([7, 7, -1]), g, lr=0.5)
    b.push(np.array([7, 7, -1]), g, lr=0.5)
    np.testing.assert_array_equal(a.pull(keys), b.pull(keys))
    np.testing.assert_allclose(a.pull([7])[0], ra[0] - 0.5 * (g[0] + g[1]),
                               rtol=1e-6)
    # rows created after the first batch come from the same stream
    np.testing.assert_array_equal(a.pull(np.arange(100, 140)),
                                  b.pull(np.arange(100, 140)))


def test_native_kv_keys_and_growth():
    from paddle_tpu_torch import native
    assert native.available()
    kv = native.NativeKV(8, init_std=0.1, seed=3)
    first = kv.pull(np.arange(100))
    kv.pull(np.arange(100, 5000))   # past the first hash capacity
    np.testing.assert_array_equal(kv.pull(np.arange(100)), first)
    assert kv.size() == 5000
    with pytest.raises(ValueError, match="INT64_MIN"):
        kv.pull([np.iinfo(np.int64).min])
    keys, rows = kv.export()
    kv2 = native.NativeKV(8, init_std=0.1, seed=99)
    kv2.import_(keys, rows)
    np.testing.assert_array_equal(kv2.pull(np.arange(100)), first)


def test_largescalekv_export_import_state_across_packages(kv_path):
    a = ps.LargeScaleKV(3, seed=2)
    a.pull(np.array([4, 9, 1]))
    a.push(np.array([9]), np.ones((1, 3)), lr=0.25)
    b = ref_ps.LargeScaleKV(1)
    b.import_state(a.export_state())
    np.testing.assert_array_equal(b.pull(np.array([4, 9, 1])),
                                  a.pull(np.array([4, 9, 1])))
    if kv_path == "numpy":
        # the RNG stream travels: rows created after the import match
        np.testing.assert_array_equal(b.pull(np.array([77, 78])),
                                      a.pull(np.array([77, 78])))
    c = ps.LargeScaleKV(1)
    c.import_state(b.export_state())
    np.testing.assert_array_equal(c.pull(np.array([4, 9, 1])),
                                  b.pull(np.array([4, 9, 1])))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_npz_saved_by_one_package_loads_in_the_other(writer, kv_path,
                                                     tmp_path):
    w = PKGS[writer].LargeScaleKV(4, seed=5)
    rows = w.pull(np.array([5, 9, -3]))
    path = str(tmp_path / "t.kv")
    w.save(path)
    with np.load(path, allow_pickle=False) as blob:
        assert set(blob.files) == {"dim", "init_std", "keys", "rows"}
    r = PKGS["ref" if writer == "port" else "port"].LargeScaleKV(1)
    r.load(path)
    np.testing.assert_array_equal(r.pull(np.array([5, 9, -3])), rows)


def test_dedup_cache_export_imports_in_the_reference():
    d = rpc.DedupCache(capacity=8)
    for i, rep in ((1, "r1"), ((5 << 32) | 2, {"x": np.arange(3.0)}),
                   (3, True)):
        assert d.begin(i) is rpc._FRESH
        d.commit(i, rep)
    ids, blobs = d.export()
    r = ref_rpc.DedupCache()
    r.import_(ids, blobs)
    assert r.begin(1) == "r1" and r.begin(3) is True
    np.testing.assert_array_equal(r.begin((5 << 32) | 2)["x"],
                                  np.arange(3.0))
    ids2, blobs2 = r.export()
    np.testing.assert_array_equal(ids2, ids)
    assert blobs2 == blobs


# ---------------------------------------------------------------------------
# the wire, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server,client", [("ref", "port"), ("port", "ref")])
def test_wire_interop_pull_push_size_save_heartbeat(server, client,
                                                    tmp_path):
    srvs = [_serve(PKGS[server], worker_timeout=0.3) for _ in range(2)]
    try:
        cl = PKGS[client].PSClient([s.endpoint for s in srvs])
        keys = np.arange(20)
        rows = cl.pull("emb", 4, keys)
        assert rows.shape == (20, 4)
        cl.push("emb", 4, keys, np.ones((20, 4)), lr=1.0)
        np.testing.assert_allclose(cl.pull("emb", 4, keys), rows - 1.0,
                                   atol=1e-6)
        # keys % shards routing, as the reference's
        assert [s.tables["emb"].size() for s in srvs] == [10, 10]
        assert cl.size("emb") == 20 and cl.size("nothing") == 0
        cl.save(str(tmp_path))
        for s in srvs:
            tag = s.endpoint.replace(":", "_")
            t = PKGS[client].LargeScaleKV(1)
            t.load(str(tmp_path / f"emb.{tag}.kv"))
            assert t.size() == 10
        cl.heartbeat(3)
        assert cl.lost_workers() == []
        time.sleep(0.45)
        assert cl.lost_workers() == [3]
        assert cl.bytes_out > 0 and cl.bytes_in > 0
        assert "paddle_tpu_rpc" in cl.metrics(0)
        cl.close()
    finally:
        for s in srvs:
            _stop(s)


@pytest.mark.parametrize("server", ["ref", "port"])
def test_two_trainer_sync_round_with_both_clients(server):
    """Trainer 0 speaks through the port's client, trainer 1 through the
    reference's: the last one through the send barrier applies the mean
    of both pushes."""
    srv = _serve(PKGS[server])
    try:
        clients = [ps.PSClient([srv.endpoint]),
                   ref_ps.PSClient([srv.endpoint])]
        keys = np.array([1, 2, 3])
        base = clients[0].pull("w", 2, keys).copy()
        grads = [np.full((3, 2), 1.0, np.float32),
                 np.full((3, 2), 3.0, np.float32)]
        out, errs = {}, []

        def trainer(w):
            try:
                c = clients[w]
                c.push("w", 2, keys, grads[w], lr=0.5, sync=True,
                       trainers=2)
                c.send_barrier(w, 2)
                out[w] = c.pull("w", 2, keys)
                c.fetch_barrier(w, 2)
            except BaseException as e:  # surfaced below
                errs.append(e)

        threads = [threading.Thread(target=trainer, args=(w,))
                   for w in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs, errs
        want = base - 0.5 * (grads[0] + grads[1]) / 2
        for w in range(2):
            np.testing.assert_allclose(out[w], want, rtol=1e-6)
        for c in clients:
            c.close()
    finally:
        _stop(srv)


@pytest.mark.parametrize("server", ["ref", "port"])
def test_dgc_round_with_both_clients(server):
    srvs = [_serve(PKGS[server]) for _ in range(2)]
    try:
        eps = [s.endpoint for s in srvs]
        clients = [ps.PSClient(eps), ref_ps.PSClient(eps)]
        parts = [(np.array([1, 4, 7]), np.array([1.0, 2.0, 3.0])),
                 (np.array([4, 5]), np.array([10.0, 20.0]))]
        res, errs = {}, []

        def trainer(w):
            try:
                res[w] = clients[w].dgc_allreduce("g", *parts[w], worker=w,
                                                  trainers=2)
            except BaseException as e:  # surfaced below
                errs.append(e)

        threads = [threading.Thread(target=trainer, args=(w,))
                   for w in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs, errs
        for w in range(2):
            idx, val = res[w]
            np.testing.assert_array_equal(idx, [1, 4, 5, 7])
            np.testing.assert_allclose(val, [1.0, 12.0, 20.0, 3.0])
        for c in clients:
            c.close()
    finally:
        for s in srvs:
            _stop(s)


def test_injected_corruption_retries_and_applies_exactly_once(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    fi.reset_injector(fi.FaultInjector(corrupt=0.25, side="both", seed=11))
    srv = _serve(ps)
    try:
        cl = ps.PSClient([srv.endpoint], backoff=0.01)
        base = cl.pull("t", 4, [0]).copy()
        for _ in range(30):
            cl.push("t", 4, [0], np.ones((1, 4)), lr=1.0)
        np.testing.assert_allclose(base - cl.pull("t", 4, [0]), 30.0,
                                   rtol=1e-6)
        assert cl.stats.retries > 0
        assert fi.injector().counters["corrupted"] > 0
        cl.close()
    finally:
        _stop(srv)


def test_invalidations_reach_a_subscriber_and_overflow_to_whole_table():
    srv = _serve(ps)
    try:
        got, seen = [], threading.Event()

        def cb(table, keys):
            got.append((table, None if keys is None else keys.tolist()))
            seen.set()

        sub = ps.PSClient([srv.endpoint])
        sub.subscribe_invalidations(cb)
        deadline = time.monotonic() + 10
        while not srv._inval_subs and time.monotonic() < deadline:
            time.sleep(0.01)
        cl = ref_ps.PSClient([srv.endpoint])
        cl.push("t", 2, [5, 6], np.ones((2, 2)))
        assert seen.wait(10)
        assert got[0] == ("t", [5, 6])
        sub.close()
        cl.close()
    finally:
        _stop(srv)
    # a full queue degrades to a whole-table invalidation, never to a
    # dropped key
    srv = ps.PSServer("127.0.0.1:0")
    try:
        srv._inval_queue_max = 1
        stream = srv._subscribe_inval()
        assert next(stream) == {"subscribed": True}
        for k in range(3):
            srv._publish_inval("t", [k])
        assert next(stream) == {"table": "t", "full": True}
        ev = next(stream)
        assert ev["table"] == "t" and ev["keys"].tolist() == [0]
        stream.close()
        assert not srv._inval_subs
    finally:
        srv.server_close()


# ---------------------------------------------------------------------------
# snapshots, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_snapshot_restores_in_the_other_package(writer, reader, kv_path,
                                                tmp_path):
    ep = W.endpoint()
    srv = _serve(PKGS[writer], ep, snapshot_dir=str(tmp_path),
                 snapshot_every=1)
    cl = rpc.RpcClient(ep)
    cl.call({"op": "pull", "table": "t", "dim": 4, "keys": np.arange(6),
             "init_std": 0.01})
    rid = cl._next_id()
    assert cl.call({"op": "push", "table": "t", "dim": 4,
                    "keys": np.array([1, 2]), "grads": np.ones((2, 4)),
                    "lr": 0.5}, req_id=rid) is True
    cl.call({"op": "push", "table": "u", "dim": 2, "keys": np.array([9]),
             "grads": np.ones((1, 2)), "lr": 1.0})
    assert srv.snapshots_taken == 2 and srv.delta_snapshots == 1
    state = {n: t.export_state() for n, t in srv.tables.items()}
    ids, blobs = srv._rpc.dedup.export()
    # rows created after the snapshot, on the never-restarted shard
    fresh = srv.tables["t"].pull(np.array([50, 51]))
    _stop(srv)

    srv2 = PKGS[reader].PSServer.restart_from_snapshot(ep, str(tmp_path))
    srv2.serve_in_thread()
    try:
        assert set(srv2.tables) == {"t", "u"}
        for n, st in state.items():
            st2 = srv2.tables[n].export_state()
            np.testing.assert_array_equal(st2["keys"], st["keys"])
            np.testing.assert_array_equal(st2["rows"], st["rows"])
        ids2, blobs2 = srv2._rpc.dedup.export()
        np.testing.assert_array_equal(ids2, ids)
        assert blobs2 == blobs
        before = srv2.tables["t"].pull(np.array([1, 2]))
        # the retried push lands on the restored dedup set: not re-applied
        assert cl.call({"op": "push", "table": "t", "dim": 4,
                        "keys": np.array([1, 2]),
                        "grads": np.ones((2, 4)), "lr": 0.5},
                       req_id=rid) is True
        np.testing.assert_array_equal(srv2.tables["t"].pull(
            np.array([1, 2])), before)
        if kv_path == "numpy":
            np.testing.assert_array_equal(
                srv2.tables["t"].pull(np.array([50, 51])), fresh)
    finally:
        cl.close()
        _stop(srv2)


def test_delta_snapshots_rewrite_only_dirty_tables(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    ep = W.endpoint()
    srv = _serve(ps, ep, snapshot_dir=str(tmp_path), snapshot_every=1)
    cl = ps.PSClient([ep])
    cl.pull("a", 4, [1, 2, 3])
    cl.pull("b", 4, [7, 8])
    cl.push("a", 4, [1], np.ones((1, 4)), lr=0.5)     # base
    assert srv.full_snapshots == 1 and srv.delta_snapshots == 0
    cl.push("b", 4, [7], np.ones((1, 4)), lr=0.5)     # delta {b}
    cl.push("b", 4, [8], 2 * np.ones((1, 4)), lr=0.5)  # delta {b}
    assert srv.delta_snapshots == 2
    deltas = sorted(f for f in os.listdir(tmp_path) if ".delta_" in f)
    assert len(deltas) == 2
    for f in deltas:
        with np.load(os.path.join(tmp_path, f), allow_pickle=False) as blob:
            meta = json.loads(bytes(blob["meta"]).decode())
            assert meta["kind"] == "delta" and set(meta["tables"]) == {"b"}
            assert "k:a" not in blob.files and "k:b" in blob.files
    ra = cl.pull("a", 4, [1, 2, 3]).copy()
    rb = cl.pull("b", 4, [7, 8]).copy()
    cl.close()
    _stop(srv)
    # the reference replays the port's base + deltas to the same state
    srv2 = ref_ps.PSServer.restart_from_snapshot(ep, str(tmp_path))
    srv2.serve_in_thread()
    try:
        cl2 = ps.PSClient([ep])
        np.testing.assert_array_equal(cl2.pull("a", 4, [1, 2, 3]), ra)
        np.testing.assert_array_equal(cl2.pull("b", 4, [7, 8]), rb)
        cl2.close()
    finally:
        _stop(srv2)


def test_snapshot_compaction_collapses_deltas(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    ep = W.endpoint()
    srv = _serve(ps, ep, snapshot_dir=str(tmp_path), snapshot_every=1)
    srv.snapshot_compact_every = 3
    cl = ps.PSClient([ep])
    for i in range(8):
        cl.push("t", 4, [i], np.ones((1, 4)), lr=0.1)
    assert srv.full_snapshots >= 2
    assert len([f for f in os.listdir(tmp_path) if ".delta_" in f]) <= 3
    want = cl.pull("t", 4, list(range(8))).copy()
    cl.close()
    _stop(srv)
    srv2 = ps.PSServer.restart_from_snapshot(ep, str(tmp_path))
    srv2.serve_in_thread()
    try:
        cl2 = ps.PSClient([ep])
        np.testing.assert_array_equal(cl2.pull("t", 4, list(range(8))),
                                      want)
        cl2.close()
    finally:
        _stop(srv2)


def test_failed_delta_write_remerges_dirty_set_and_idle_does_not_churn(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    srv = ps.PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path),
                      snapshot_every=0)
    srv.table("t", 4).push(np.array([1]), np.ones((1, 4)), 1.0)
    srv._mark_dirty("t")
    srv.snapshot()                         # base
    taken = srv.snapshots_taken
    for _ in range(3):
        srv.snapshot()                     # nothing new: no file
    assert srv.snapshots_taken == taken
    srv._mark_dirty("t")
    orig = srv._write_snapshot
    srv._write_snapshot = lambda *a: (_ for _ in ()).throw(
        OSError("disk full"))
    with pytest.raises(OSError):
        srv.snapshot()
    assert "t" in srv._dirty and srv._snap_pending
    srv._write_snapshot = orig
    srv._after_retry("push")               # a dedup-hit retry lands it
    assert srv.delta_snapshots == 1 and not srv._dirty
    n = srv.snapshots_taken
    srv._after_retry("push")               # nothing owed: no churn
    assert srv.snapshots_taken == n
    srv.server_close()


def test_concurrent_pushes_with_interval_snapshots_no_deadlock(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    srv = _serve(ps, snapshot_dir=str(tmp_path), snapshot_every=1,
                 snapshot_interval=0.02)
    try:
        clients = [ps.PSClient([srv.endpoint]) for _ in range(3)]

        def work(c, wid):
            for k in range(20):
                c.push("t", 4, [wid * 100 + k], np.ones((1, 4)), lr=1.0)

        threads = [threading.Thread(target=work, args=(c, i))
                   for i, c in enumerate(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), \
            "push/snapshot deadlock"
        assert clients[0].size("t") == 60 and srv.snapshots_taken > 0
        for c in clients:
            c.close()
    finally:
        _stop(srv)


# ---------------------------------------------------------------------------
# configurations left to later items raise, naming them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,env,item", [
    ({"wal": True}, {}, "16(b)"),
    ({}, {"PADDLE_PS_WAL": "1"}, "16(b)"),
    ({"wal_bg_replay": True}, {}, "16(b)"),
    ({"primary": "127.0.0.1:1"}, {}, "16(b)"),
    ({}, {"PADDLE_PS_HA_EPOCH": "2"}, "16(b)"),
    ({"tier_warm_bytes": 1 << 20}, {}, "16(b)"),
    ({}, {"PADDLE_PS_TIER_WARM_BYTES": "1048576"}, "16(b)"),
    ({"publish_dir": "pub"}, {}, "17"),
    ({}, {"PADDLE_TPU_PUBLISH_DIR": "pub"}, "17"),
    ({}, {"PADDLE_TPU_TELEMETRY_HOST": "1"}, "18"),
], ids=["wal", "wal_env", "wal_bg_replay", "ha_primary", "ha_epoch_env",
        "tier", "tier_env", "publish", "publish_env", "telemetry_host"])
def test_unported_server_configurations_raise(kw, env, item, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=re.escape(f"item {item}")):
        ps.PSServer("127.0.0.1:0", **kw)


def test_ha_group_and_ha_verbs_raise_naming_16b():
    with pytest.raises(NotImplementedError, match=r"item 16\(b\)"):
        ps.PSClient(["127.0.0.1:1|127.0.0.1:2"])
    srv = _serve(ps)
    try:
        cl = rpc.RpcClient(srv.endpoint, max_retries=0)
        for req in ({"op": "ha_status"}, {"op": "ping", "_epoch": 3}):
            with pytest.raises(rpc.PSRemoteError, match=r"item 16\(b\)"):
                cl.call(req)
        with pytest.raises(rpc.PSRemoteError, match=r"item 17"):
            cl.call({"op": "pub_latest"})
        assert cl.call({"op": "ping"}) == "pong"
        cl.close()
    finally:
        _stop(srv)


def test_new_modules_import_without_jax_and_shards_without_torch():
    code = (
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n"
        "import paddle_tpu_torch.distributed.fleet.runtime"
        ".parameter_server_runtime\n"
        "import paddle_tpu_torch.distributed.fleet.boxps_cache\n"
        "import paddle_tpu_torch.distributed.fleet.ps_roles\n"
        "import paddle_tpu_torch.distributed.fs, paddle_tpu_torch.native\n"
        "assert 'torch' not in sys.modules, 'the shard path imports torch'\n"
        "import paddle_tpu_torch.distributed.fleet.fleet_wrapper\n"
        "import paddle_tpu_torch.distributed.fleet.heter_worker\n"
        "import paddle_tpu_torch.incubate.fleet.parameter_server"
        ".distribute_transpiler\n"
        "from paddle_tpu_torch.distributed import fleet\n"
        "assert fleet.FleetWrapper and fleet.DownpourWorker\n"
        "assert fleet.BoxPSWrapper and fleet.HeterCpuWorker\n"
        "assert fleet.HeterDenseWorker\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=W.REPO,
                         env=W.role_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# the fleet PS lifecycle through both fleets
# ---------------------------------------------------------------------------

def test_fleet_ps_lifecycle():
    from paddle_tpu_torch.distributed.fleet import Role, UserDefinedRoleMaker
    from paddle_tpu_torch.distributed.fleet.base.fleet_base import Fleet
    server_fleet = Fleet()
    server_fleet.init(UserDefinedRoleMaker(
        current_id=0, role=Role.SERVER, server_endpoints=["127.0.0.1:0"]))
    server_fleet.init_server()
    srv = server_fleet.run_server(block=False)
    try:
        worker_fleet = Fleet()
        worker_fleet.init(UserDefinedRoleMaker(
            current_id=0, role=Role.WORKER, worker_num=1,
            server_endpoints=[srv.endpoint]))
        assert worker_fleet.is_worker() and worker_fleet.server_num() == 1
        client = worker_fleet.init_worker()
        rows = client.pull("table0", 8, np.array([1, 2, 3]))
        assert rows.shape == (3, 8)
        worker_fleet.stop_worker()
    finally:
        server_fleet._runtime().stop_server()


def test_fleet_init_server_loads_saved_tables(tmp_path):
    from paddle_tpu_torch.distributed.fleet import Role, UserDefinedRoleMaker
    from paddle_tpu_torch.distributed.fleet.base.fleet_base import Fleet
    ep = W.endpoint()
    srv = _serve(ref_ps, ep)
    cl = ps.PSClient([ep])
    rows = cl.pull("emb", 4, np.arange(5))
    cl.save(str(tmp_path))
    cl.close()
    _stop(srv)
    f = Fleet()
    f.init(UserDefinedRoleMaker(current_id=0, role=Role.SERVER,
                                server_endpoints=[ep]))
    f.init_server(str(tmp_path))
    srv2 = f.run_server(block=False)
    try:
        np.testing.assert_array_equal(srv2.tables["emb"].pull(np.arange(5)),
                                      rows)
    finally:
        f._runtime().stop_server()


def test_incubate_fleet_ps_lifecycle():
    from paddle_tpu_torch.incubate.fleet.base.role_maker import (
        Role, UserDefinedRoleMaker)
    from paddle_tpu_torch.incubate.fleet.parameter_server import \
        distribute_transpiler as dt
    ep = W.endpoint()
    server = dt._Fleet()
    server.init(UserDefinedRoleMaker(current_id=0, role=Role.SERVER,
                                     server_endpoints=[ep]))
    assert server.is_server() and not server.is_worker()
    server.init_server()
    th = threading.Thread(target=server.run_server, daemon=True)
    th.start()
    try:
        worker = dt._Fleet()
        worker.init(UserDefinedRoleMaker(current_id=1, role=Role.WORKER,
                                         worker_num=2,
                                         server_endpoints=[ep]))
        assert worker.is_worker() and worker.worker_index() == 1
        assert worker.worker_num() == 2 and worker.server_num() == 1
        cl = ps.PSClient([ep])
        assert cl.pull("table0", 8, np.array([1, 2, 3])).shape == (3, 8)
        cl.close()
        cfg = dt.StrategyFactory.create_geo_strategy(7)
        assert not cfg.sync_mode and cfg.geo_sgd_need_push_nums == 7
        with pytest.raises(NotImplementedError, match="item 12"):
            worker.distributed_optimizer(object()).minimize(None)
    finally:
        deadline = time.monotonic() + 10
        while server._server is None and time.monotonic() < deadline:
            time.sleep(0.01)
        server.stop_server()
        th.join(timeout=10)
        server._server.server_close()
    assert not th.is_alive()


# ---------------------------------------------------------------------------
# frame corruption + a shard kill after commit, before the reply: the
# final tables bit-equal to the fault-free run
# ---------------------------------------------------------------------------

def _train_and_collect(ep, cfg, batches):
    from paddle_tpu_torch.distributed.fleet import (DownpourWorker,
                                                    FleetWrapper)
    fw = FleetWrapper(endpoints=[ep])
    worker = DownpourWorker(fw, cfg, lr=0.1, seed=7, device="cpu")
    worker.push_initial_dense()
    for b in batches:
        worker.train_one_batch(*b)
    final = W.run_tables(fw, worker, cfg)
    stats = fw.transport_stats()
    fw.stop()
    return final, stats


def test_widedeep_survives_corruption_and_server_kill_bit_for_bit(
        tmp_path, monkeypatch):
    from paddle_tpu_torch.models.wide_deep import WideDeepConfig
    cfg = WideDeepConfig(vocab_size=512, num_slots=4, embed_dim=4,
                         dense_dim=3, hidden=(16, 8))
    batches = W.ctr_batches(cfg, 12, batch=32, seed=1234)
    snap = dict(PADDLE_TPU_DISABLE_NATIVE="1", PADDLE_PS_SNAPSHOT_EVERY="1")
    procs = []
    try:
        ep1 = W.endpoint()
        p1, _ = W.spawn_shard(ep1, PADDLE_PS_SNAPSHOT_DIR=tmp_path / "ref",
                              **snap)
        procs.append(p1)
        want, _ = _train_and_collect(ep1, cfg, batches)

        ep2 = W.endpoint()
        snap2 = tmp_path / "faulty"
        p2, _ = W.spawn_shard(ep2, PADDLE_PS_SNAPSHOT_DIR=snap2,
                              PADDLE_PS_FAULT_KILL_AFTER="100",
                              PADDLE_PS_FAULT_KILL_POINT="reply",
                              PADDLE_PS_FAULT_SEED="3", **snap)
        procs.append(p2)
        restarted, errs = [], []
        stop_watch = threading.Event()

        def watch():
            try:
                while not stop_watch.is_set():
                    if p2.poll() is not None:
                        assert p2.returncode == fi.KILL_EXIT_CODE
                        p, ready = W.spawn_shard(
                            ep2, PADDLE_PS_SNAPSHOT_DIR=snap2, **snap)
                        procs.append(p)
                        assert ready["restored"]
                        restarted.append(p)
                        return
                    time.sleep(0.02)
            except BaseException as e:  # surfaced below
                errs.append(e)

        watcher = threading.Thread(target=watch)
        watcher.start()
        monkeypatch.setenv("PADDLE_PS_BACKOFF", "0.02")
        monkeypatch.setenv("PADDLE_PS_DEADLINE", "60")
        fi.reset_injector(fi.FaultInjector(corrupt=0.02, side="client",
                                           seed=17))
        try:
            got, stats = _train_and_collect(ep2, cfg, batches)
            corrupted = fi.injector().counters["corrupted"]
        finally:
            fi.reset_injector(fi.FaultInjector())
            stop_watch.set()
            watcher.join(timeout=60)
    finally:
        W.stop(procs)
    assert not errs, errs
    assert restarted, "fault injection never killed the shard"
    assert stats["retries"] > 0 and corrupted > 0, (stats, corrupted)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
