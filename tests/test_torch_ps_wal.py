"""The port's row-level WAL tier on the parameter server
(paddle_tpu_torch/distributed/fleet/runtime/parameter_server_runtime.py
with checkpoint/wal.py) against the JAX package's: a push journals only
its touched rows, restart = base + journal replay (blocking or in the
background behind the read-through gate), compaction, a shard killed
after a commit and before its reply, and journals written by one
package's shard replaying in the other's, bit for bit."""
import os
import shutil
import threading
import time

import numpy as np
import pytest

import torch_ps_workers as W
from paddle_tpu.distributed.fleet.runtime import \
    parameter_server_runtime as ref_ps
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.distributed.fleet.runtime import \
    parameter_server_runtime as ps
from paddle_tpu_torch.distributed.fleet.runtime import rpc
from paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime \
    import LargeScaleKV, PSClient, PSServer

PKGS = {"port": ps, "ref": ref_ps}


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


@pytest.fixture
def numpy_kv(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _snap_dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f))
               for f in os.listdir(d))


def _assert_state_equal(want: dict, got: dict, rng: bool = True):
    assert set(want) == set(got)
    for n in want:
        np.testing.assert_array_equal(want[n]["keys"], got[n]["keys"])
        np.testing.assert_array_equal(want[n]["rows"], got[n]["rows"])
        if rng:
            a, b = want[n]["rng"], got[n]["rng"]
            assert a["pos"] == b["pos"] and a["has_gauss"] == b["has_gauss"]
            np.testing.assert_array_equal(a["key"], b["key"])


# ---------------------------------------------------------------------------
# the table surface the WAL needs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_rows_for_missing_keys_apply_rows_match_the_reference(
        native, monkeypatch):
    if native:
        monkeypatch.delenv("PADDLE_TPU_DISABLE_NATIVE", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    a, b = LargeScaleKV(4, seed=3), ref_ps.LargeScaleKV(4, seed=3)
    assert (a._native is None) == (b._native is None)
    for t in (a, b):
        t.pull(np.arange(6))
    if not native:
        np.testing.assert_array_equal(a.missing_keys([9, 2, 9, 7]),
                                      b.missing_keys([9, 2, 9, 7]))
        np.testing.assert_array_equal(a.missing_keys([9, 2, 9, 7]),
                                      [9, 7])
    else:
        assert a.missing_keys([9]) is None and b.missing_keys([9]) is None
    rows = np.full((3, 4), 2.5, np.float32)
    for t in (a, b):
        t.apply_rows(np.array([4, 11, 12]), rows)
    np.testing.assert_array_equal(a.rows_for(np.array([4, 11, 12])), rows)
    np.testing.assert_array_equal(a.rows_for(np.array([0, 4, 11])),
                                  b.rows_for(np.array([0, 4, 11])))
    # the created rows consumed the init stream as the reference's did
    np.testing.assert_array_equal(a.pull(np.array([40, 41])),
                                  b.pull(np.array([40, 41])))


# ---------------------------------------------------------------------------
# the JAX package's WAL cases, on the port
# ---------------------------------------------------------------------------

def test_wal_journals_only_touched_rows(tmp_path, numpy_kv):
    """Bytes written per push scale with ROWS TOUCHED, not table size."""
    srv = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path), wal=True)
    srv.serve_in_thread()
    cl = PSClient([srv.endpoint])
    try:
        dim = 8
        rng = np.random.RandomState(0)
        cl.push("emb", dim, np.arange(1000), rng.randn(1000, dim))
        table_bytes = 1000 * dim * 4
        per_push = []
        for i in range(4):
            before = _snap_dir_bytes(str(tmp_path))
            cl.push("emb", dim, [3 + i, 900 - i], rng.randn(2, dim))
            per_push.append(_snap_dir_bytes(str(tmp_path)) - before)
        assert all(0 < b < table_bytes / 20 for b in per_push), \
            (per_push, table_bytes)
        # no delta npz files in WAL mode — the journal replaced them
        assert not [f for f in os.listdir(tmp_path) if ".delta_" in f]
        assert srv._wal.rows_appended >= 1000 + 8
    finally:
        cl.close()
        _stop(srv)


@pytest.mark.parametrize("replicated", [False, True])
def test_wal_restore_equals_synchronous_state(replicated, tmp_path,
                                              numpy_kv):
    """Restore = base + WAL replay equals the live state exactly: rows,
    key order, the per-table RNG stream and the re-armed dedup ids;
    with a hot standby attached the journal is unchanged and the
    standby converges to the same state."""
    srv = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "prim"),
                   wal=True)
    srv.serve_in_thread()
    stby = None
    if replicated:
        stby = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "sb"),
                        wal=True, primary=srv.endpoint)
        stby.serve_in_thread()
    ep = srv.endpoint
    cl = PSClient([ep])
    rng = np.random.RandomState(7)
    cl.push("emb", 8, np.arange(50), rng.randn(50, 8))
    cl.push("emb", 8, [3, 9], rng.randn(2, 8))
    cl.pull("emb", 8, [3, 9, 777])        # 777: lazy init, consumes RNG
    cl.push("wide", 4, [5], rng.randn(1, 4))
    live = {n: t.export_state() for n, t in srv.tables.items()}
    dedup_ids = len(srv._rpc.dedup._order)
    if stby is not None:
        try:
            W.wait_for(lambda: stby._ha_replicator.synced.is_set()
                       and stby._ha_replicator.applied_seq
                       >= srv._ha.seq, what="standby catch-up")
            _assert_state_equal(
                live, {n: t.export_state()
                       for n, t in stby.tables.items()})
        finally:
            _stop(stby)
    cl.close()
    _stop(srv)

    srv2 = PSServer.restart_from_snapshot(ep, str(tmp_path / "prim"),
                                          wal=True)
    try:
        _assert_state_equal(live, {n: t.export_state()
                                   for n, t in srv2.tables.items()})
        assert len(srv2._rpc.dedup._order) == dedup_ids > 0
        np.testing.assert_array_equal(
            srv.tables["emb"].pull(np.array([888])),
            srv2.tables["emb"].pull(np.array([888])))
    finally:
        srv2.server_close()


def test_wal_compaction_folds_journal_into_base(tmp_path, numpy_kv):
    """Past the byte threshold the journal compacts into a full base
    and rotates; superseded journals go, and restore stays exact."""
    srv = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path), wal=True)
    srv.wal_compact_bytes = 1500
    srv.serve_in_thread()
    cl = PSClient([srv.endpoint])
    for i in range(24):
        cl.push("t", 4, [i], np.ones((1, 4)))
    assert srv.full_snapshots >= 1
    assert len([f for f in os.listdir(tmp_path) if ".wal_" in f]) == 1
    live = srv.tables["t"].export_state()
    ep = srv.endpoint
    cl.close()
    _stop(srv)
    srv2 = PSServer.restart_from_snapshot(ep, str(tmp_path), wal=True)
    try:
        rest = srv2.tables["t"].export_state()
        np.testing.assert_array_equal(live["keys"], rest["keys"])
        np.testing.assert_array_equal(live["rows"], rest["rows"])
    finally:
        srv2.server_close()


def test_wal_server_kill_restart_bit_for_bit(tmp_path, monkeypatch):
    """A WAL-mode shard process killed after a commit and before its
    reply, respawned on its endpoint: the client retries across the
    respawn and the table equals a fault-free run's bit for bit, from
    the journal alone (no stride snapshots)."""
    monkeypatch.setenv("PADDLE_PS_BACKOFF", "0.02")
    monkeypatch.setenv("PADDLE_PS_DEADLINE", "120")
    wal = dict(PADDLE_PS_WAL="1", PADDLE_TPU_DISABLE_NATIVE="1")

    def run(snap, extra):
        ep = W.endpoint()
        procs = []
        restarted, errs = [], []
        stop = threading.Event()
        try:
            p, _ = W.spawn_shard(ep, PADDLE_PS_SNAPSHOT_DIR=snap,
                                 **wal, **extra)
            procs.append(p)

            def watch():
                try:
                    while not stop.is_set():
                        if p.poll() is not None:
                            assert p.returncode == fi.KILL_EXIT_CODE
                            p2, ready = W.spawn_shard(
                                ep, PADDLE_PS_SNAPSHOT_DIR=snap, **wal)
                            procs.append(p2)
                            assert ready["restored"] and ready["wal"]
                            restarted.append(p2)
                            return
                        time.sleep(0.02)
                except BaseException as e:  # surfaced below
                    errs.append(e)

            w = threading.Thread(target=watch)
            w.start()
            try:
                cl = PSClient([ep])
                rng = np.random.RandomState(11)
                for i in range(40):
                    cl.push("emb", 4, [i % 13, (i * 7) % 13],
                            rng.randn(2, 4))
                out = cl.pull("emb", 4, np.arange(13))
                cl.close()
            finally:
                stop.set()
                w.join(timeout=60)
        finally:
            W.stop(procs)
        assert not errs, errs
        return out, bool(restarted)

    ref, _ = run(tmp_path / "ref", {})
    faulty, restarted = run(tmp_path / "faulty", {
        "PADDLE_PS_FAULT_KILL_AFTER": "25",
        "PADDLE_PS_FAULT_KILL_POINT": "reply"})
    assert restarted, "kill threshold never hit"
    np.testing.assert_array_equal(ref, faulty)


# ---------------------------------------------------------------------------
# background replay behind the read-through gate
# ---------------------------------------------------------------------------

def _build_wal_server(mod, snap_dir, ep="127.0.0.1:0"):
    """A WAL shard with state split across a compacted base AND a
    journal tail, including a lazily initialised row."""
    srv = mod.PSServer(ep, snapshot_dir=snap_dir, wal=True)
    srv.wal_compact_bytes = 1500
    srv.serve_in_thread()
    cl = rpc.RpcClient(srv.endpoint)
    rng = np.random.RandomState(3)

    def push(table, dim, keys, grads, rid):
        cl.call({"op": "push", "table": table, "dim": dim,
                 "keys": np.asarray(keys, np.int64),
                 "grads": np.asarray(grads, np.float32), "lr": 1.0,
                 "init_std": 0.01}, req_id=rid)

    for i in range(24):                   # crosses the compact bytes
        push("emb", 8, [i], rng.randn(1, 8), 1000 + i)
    assert srv.full_snapshots >= 1        # base npz committed
    push("emb", 8, [100, 101], rng.randn(2, 8), 2000)   # journal tail
    cl.call({"op": "pull", "table": "emb", "dim": 8,
             "keys": np.array([500], np.int64), "init_std": 0.01})
    push("wide", 4, [5], rng.randn(1, 4), 2001)
    state = {n: t.export_state() for n, t in srv.tables.items()}
    dedup = srv._rpc.dedup.export()
    ep = srv.endpoint
    cl.close()
    _stop(srv)
    return ep, state, dedup


def test_wal_bg_replay_state_parity_with_blocking(tmp_path, numpy_kv):
    """Background replay reaches bit for bit the state blocking replay
    does: rows, key order, RNG stream, re-armed dedup ids."""
    snap = str(tmp_path / "snap")
    os.makedirs(snap)
    ep, live, _ = _build_wal_server(ps, snap)
    snap2 = str(tmp_path / "snap2")
    shutil.copytree(snap, snap2)
    blocking = PSServer.restart_from_snapshot(ep, snap, wal=True)
    try:
        block_state = {n: t.export_state()
                       for n, t in blocking.tables.items()}
        block_dedup = len(blocking._rpc.dedup._order)
        block_fresh = blocking.tables["emb"].pull(np.array([888]))
    finally:
        blocking.server_close()
    bg = PSServer.restart_from_snapshot(ep, snap2, wal=True,
                                        wal_bg_replay=True)
    try:
        assert bg._replay_done.wait(60)
        _assert_state_equal(live, block_state)
        _assert_state_equal(live, {n: t.export_state()
                                   for n, t in bg.tables.items()})
        assert block_dedup == len(bg._rpc.dedup._order) > 0
        np.testing.assert_array_equal(
            block_fresh, bg.tables["emb"].pull(np.array([888])))
    finally:
        bg.server_close()


def test_wal_bg_replay_gate_serves_stale_reads(tmp_path, numpy_kv,
                                               monkeypatch):
    """During background replay, pulls of rows the base holds come back
    at once, stale-marked; a pull that would create a row waits for the
    replay and returns the exact post-replay value."""
    snap = str(tmp_path / "snap")
    os.makedirs(snap)
    ep, live, _ = _build_wal_server(ps, snap)
    release = threading.Event()
    orig_replay = PSServer._replay_wal

    def held_replay(self):
        release.wait(60)
        return orig_replay(self)

    monkeypatch.setattr(PSServer, "_replay_wal", held_replay)
    srv = PSServer.restart_from_snapshot(ep, snap, wal=True,
                                         wal_bg_replay=True)
    srv.serve_in_thread()
    cl = PSClient([srv.endpoint])
    try:
        assert not srv._replay_done.is_set()
        vals = cl.pull("emb", 8, [0, 1, 2])
        assert cl.last_pull_stale and cl.stale_pulls == 1
        np.testing.assert_array_equal(vals, live["emb"]["rows"][:3])
        got = {}

        def blocked_pull():
            c2 = PSClient([srv.endpoint])
            got["v"] = c2.pull("emb", 8, [100])
            got["stale"] = c2.last_pull_stale
            c2.close()

        th = threading.Thread(target=blocked_pull)
        th.start()
        th.join(0.5)
        assert th.is_alive() and "v" not in got   # genuinely gated
        release.set()
        th.join(60)
        assert not th.is_alive() and srv._replay_done.is_set()
        assert got["stale"] is False
        idx = list(live["emb"]["keys"]).index(100)
        np.testing.assert_array_equal(got["v"][0],
                                      live["emb"]["rows"][idx])
        cl.pull("emb", 8, [0])
        assert cl.last_pull_stale is False and cl.stale_pulls == 1
    finally:
        release.set()
        cl.close()
        _stop(srv)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_wal_replays_in_the_other_package(writer, reader, tmp_path,
                                          numpy_kv):
    """A base + journal written by one package's shard restores in the
    other's: equal tables, RNG streams, dedup ids and encoded replies,
    and the same rows drawn afterwards."""
    snap = str(tmp_path / "snap")
    os.makedirs(snap)
    ep, live, (ids, blobs) = _build_wal_server(PKGS[writer], snap,
                                               W.endpoint())
    srv = PKGS[reader].PSServer.restart_from_snapshot(ep, snap, wal=True)
    try:
        _assert_state_equal(live, {n: t.export_state()
                                   for n, t in srv.tables.items()})
        ids2, blobs2 = srv._rpc.dedup.export()
        np.testing.assert_array_equal(ids2, ids)
        assert blobs2 == blobs
        fresh = srv.tables["emb"].pull(np.array([888, 889]))
    finally:
        srv.server_close()
    # the writer's own restart draws the same fresh rows
    again = PKGS[writer].PSServer.restart_from_snapshot(ep, snap,
                                                         wal=True)
    try:
        np.testing.assert_array_equal(
            again.tables["emb"].pull(np.array([888, 889])), fresh)
    finally:
        again.server_close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_wal_journal_bytes_equal_across_packages(native, tmp_path,
                                                 monkeypatch):
    """The same requests (same request ids) to a port shard and a
    reference shard write byte-identical journals."""
    if native:
        monkeypatch.delenv("PADDLE_TPU_DISABLE_NATIVE", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    journals = {}
    for name, mod in PKGS.items():
        d = tmp_path / name
        srv = mod.PSServer("127.0.0.1:0", snapshot_dir=str(d), wal=True)
        srv.serve_in_thread()
        cl = rpc.RpcClient(srv.endpoint)
        try:
            rng = np.random.RandomState(5)
            for i in range(6):
                cl.call({"op": "push", "table": "emb", "dim": 4,
                         "keys": np.array([i, i + 3], np.int64),
                         "grads": rng.randn(2, 4).astype(np.float32),
                         "lr": 0.5, "init_std": 0.01}, req_id=77 + i)
            cl.call({"op": "pull", "table": "emb", "dim": 4,
                     "keys": np.array([40, 41], np.int64),
                     "init_std": 0.01})
        finally:
            cl.close()
            _stop(srv)
        wal, = [f for f in os.listdir(d) if ".wal_" in f]
        journals[name] = (d / wal).read_bytes()
    assert len(journals["port"]) > 0
    assert journals["port"] == journals["ref"]


def test_journal_inside_the_commit_scope_semisync_wait_outside(
        tmp_path, numpy_kv, monkeypatch):
    """Lock order: the WAL append runs under the apply lock (inside
    the commit scope), the semi-sync wait runs after it is released,
    so a push waiting for its standby's ack never holds other pushes
    back."""
    monkeypatch.setenv("PADDLE_PS_HA_SEMISYNC", "1")
    prim = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "p"),
                    wal=True)
    prim.serve_in_thread()
    stby = PSServer("127.0.0.1:0", snapshot_dir=str(tmp_path / "s"),
                    wal=True, primary=prim.endpoint)
    stby.serve_in_thread()
    seen = {"journal": [], "wait": []}
    journal, wait = prim._journal, prim._ha.wait_semisync

    def journal_spy(*a):
        seen["journal"].append(prim._apply_lock._is_owned())
        return journal(*a)

    def wait_spy(rid):
        seen["wait"].append(prim._apply_lock._is_owned())
        return wait(rid)

    prim._rpc.journal = journal_spy
    monkeypatch.setattr(prim._ha, "wait_semisync", wait_spy)
    cl = PSClient([prim.endpoint])
    try:
        W.wait_for(lambda: stby._ha_replicator.synced.is_set(),
                   what="standby bootstrap")
        for i in range(3):
            cl.push("t", 4, [i], np.ones((1, 4)))
        assert seen["journal"] == [True] * 3
        assert seen["wait"] == [False] * 3
        assert prim._ha.degraded == 0
    finally:
        cl.close()
        _stop(stby)
        _stop(prim)
