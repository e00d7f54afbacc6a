"""The port's online-learning publish tier (paddle_tpu_torch/publish/) on
the CPU, held to the JAX package's (paddle_tpu/publish/):

  * the cases of tests/test_publish.py on the port: registry durability
    (pin, rollback, a corrupt file keeps the previous commit), watch
    announces in process and over the wire, chunk-dedup publications,
    a kill between the manifest and the registry record, the PS
    exporter's cadence with the pub_* verbs on the shard's own wire,
    background WAL replay parity and its read gate, the multi-host
    manifest merge, the metric names; the reference's lock-sanitizer
    re-run (the sanitizer is not ported) becomes a concurrency drill
    over the same lock surface;
  * cross-package, bit for bit: parity digests, manifests and registry
    payloads of the same arrays; a root the JAX Publisher wrote from a
    tiny GPTDecodeModel adopted by the port's VersionSubscriber into a
    port Engine (its parameters equal the published tree exactly, its
    greedy tokens the JAX engine's); the JAX VersionRegistry reading
    the port's latest / pinned / rollbacks; seeded pushes into both
    packages' publish-wired PSServers publishing equal table rows.

Tolerance: equality everywhere, except that a greedy token of the JAX
engine may differ where its top-2 logits tie within TIE_TOL (the rule
of tests/test_torch_serving_frontend.py). Every wait has its own
timeout.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.distributed.fleet.runtime import \
    parameter_server_runtime as ref_ps
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.publish import Publisher as JPublisher
from paddle_tpu.publish import VersionRegistry as JRegistry
from paddle_tpu.publish import parity_digest as j_parity_digest
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import GPTDecodeModel as JModel
from paddle_tpu_torch.checkpoint import manifest as manifest_mod
from paddle_tpu_torch.checkpoint.store import CheckpointStore
from paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime \
    import PSClient, PSServer
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.publish import (Publisher, RegistryClient,
                                      RegistryError, RegistryServer,
                                      VersionRegistry, VersionSubscriber,
                                      parity_digest)
from paddle_tpu_torch.serving import Engine, GPTDecodeModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(vocab_size=512, hidden_size=128, num_heads=2, num_layers=2,
            max_position_embeddings=128, initializer_range=0.5)
ENGINE_KW = dict(num_slots=4, num_pages=32, page_size=8, max_seq_len=64)
TIE_TOL = 2e-4
PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8], [100, 200, 300, 400, 500]]
NEW = 7


def _wait_for(pred, timeout=30.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


# ---------------------------------------------------------------------------
# version registry
# ---------------------------------------------------------------------------

def test_registry_publish_pin_rollback_roundtrip(tmp_path):
    reg = VersionRegistry(str(tmp_path))
    assert reg.latest() == 0 and reg.record_latest() is None
    r1 = reg.publish(reg.next_version(), step=10, kind="gpt-decode",
                     digest="d1", run="trainer:0")
    assert r1["version"] == 1 and reg.latest() == 1
    reg.pin(1)
    r2 = reg.publish(reg.next_version(), step=20, kind="gpt-decode",
                     digest="d2")
    assert r2["version"] == 2 and r2["pinned"] == 1
    # a second handle on the same root sees the committed state
    other = VersionRegistry(str(tmp_path))
    assert other.latest() == 2 and other.pinned() == 1
    assert other.get(1)["digest"] == "d1"
    assert [r["version"] for r in other.versions()] == [1, 2]
    # rollback defaults to the pinned version and counts
    back = reg.rollback()
    assert back["version"] == 1 and reg.latest() == 1
    assert reg.rollbacks() == 1
    # version numbers never reuse a rolled-back slot
    assert reg.next_version() == 3
    with pytest.raises(RegistryError):
        reg.pin(99)


def test_registry_corrupt_file_keeps_previous_state(tmp_path):
    reg = VersionRegistry(str(tmp_path))
    reg.publish(1, step=1, kind="k")
    reg.publish(2, step=2, kind="k")
    with open(reg.path, "r+b") as f:   # disk corruption, post-commit
        f.seek(10)
        f.write(b"\x00\x00\x00")
    # reload refuses the corrupt bytes; in-memory state stays
    assert reg.reload() is False and reg.latest() == 2
    # and the next commit repairs the file for cold readers
    reg.publish(3, step=3, kind="k")
    assert VersionRegistry(str(tmp_path)).latest() == 3


def test_registry_watch_announces_in_process(tmp_path):
    reg = VersionRegistry(str(tmp_path))
    sid, sub = reg.watch_queue()
    reg.publish(1, step=5, kind="k")
    ev = sub.q.get(timeout=5)
    assert ev["version"] == 1 and ev["step"] == 5
    reg.publish(2, step=6, kind="k")
    assert sub.q.get(timeout=5)["version"] == 2
    reg.rollback()                        # no pin: newest-older wins
    back = sub.q.get(timeout=5)
    assert back["version"] == 1           # rollback announced too
    reg.unwatch(sid)


def test_registry_server_wire_roundtrip(tmp_path):
    with RegistryServer(str(tmp_path)) as srv:
        cli = RegistryClient(srv.endpoint, timeout=30.0)
        try:
            rec = cli.publish(1, step=7, kind="gpt-decode", digest="x")
            assert rec["version"] == 1
            cli.pin(1)
            cli.publish(2, step=9, kind="gpt-decode")
            got = cli.latest()
            assert got["latest"] == 2 and got["pinned"] == 1
            assert cli.get(2)["step"] == 9
            back = cli.rollback()
            assert back["version"] == 1
            assert cli.list()["rollbacks"] == 1
            # watch catches up from the subscribe ack, then streams
            seen = []
            stop = cli.watch(seen.append)
            assert _wait_for(lambda: len(seen) >= 1)
            assert seen[0]["version"] == 1        # current latest
            cli.publish(3, step=11, kind="gpt-decode")
            assert _wait_for(
                lambda: any(r["version"] == 3 for r in seen))
            stop.set()
        finally:
            cli.close()


# ---------------------------------------------------------------------------
# publisher: dedup + parity digest + crash safety
# ---------------------------------------------------------------------------

def test_publish_dedup_across_versions(tmp_path):
    pub = Publisher(str(tmp_path),
                    store=CheckpointStore(str(tmp_path),
                                          chunk_bytes=4096, keep=4))
    big = np.random.RandomState(0).randn(64, 256).astype(np.float32)
    r1 = pub.publish_arrays({"w": big}, step=1, kind="gpt-decode")
    assert r1["version"] == 1
    mutated = big.copy()
    mutated[0, 0] += 1.0                  # one chunk of ~16 dirty
    r2 = pub.publish_arrays({"w": mutated}, step=2, kind="gpt-decode")
    assert r2["version"] == 2
    assert r2["extra"]["dedup"] >= 0.9    # ~15/16 chunks re-referenced
    assert pub.last_dedup_ratio == r2["extra"]["dedup"]
    # digests track content identity: v2 differs, a byte-identical
    # republication digests equal to v2
    r3 = pub.publish_arrays({"w": mutated}, step=3, kind="gpt-decode")
    assert r1["digest"] != r2["digest"] == r3["digest"]
    assert r3["extra"]["dedup"] == 1.0    # nothing rewritten at all
    # every version restores independently, bit-for-bit
    st = pub.store
    np.testing.assert_array_equal(st.restore(step=1)[0]["w"], big)
    np.testing.assert_array_equal(st.restore(step=2)[0]["w"], mutated)


def test_kill_mid_publication_subprocess_previous_servable(tmp_path):
    """Crash BETWEEN the manifest commit and the registry record (the
    widest window a real kill can hit): the dangling manifest is
    invisible, the previous version stays latest and restores
    bit-for-bit, and the next publication reclaims the version
    number."""
    root = str(tmp_path)
    code = f"""
import os, numpy as np
from paddle_tpu_torch.publish import Publisher
pub = Publisher({root!r})
v1 = np.arange(100, dtype=np.float32)
pub.publish_arrays({{"w": v1}}, step=1, kind="gpt-decode")
# second publication: data commit lands, then die before the registry
version = pub.registry.next_version()
pub.store.save({{"w": v1 * 2}}, step=version,
               meta={{"kind": "gpt-decode", "step": 2}})
os._exit(9)
"""
    p = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert p.returncode == 9, p.stderr[-2000:]
    reg = VersionRegistry(root)
    assert reg.latest() == 1              # v2 never became visible
    rec = reg.record_latest()
    store = CheckpointStore(root)
    payload = store.latest_manifest(reg.latest())
    assert parity_digest(payload) == rec["digest"]  # bit-for-bit check
    arrays, _meta = store.restore(step=reg.latest())
    np.testing.assert_array_equal(
        arrays["w"], np.arange(100, dtype=np.float32))
    # recovery: the next publication takes over the dangling number
    pub = Publisher(root)
    r2 = pub.publish_arrays(
        {"w": np.arange(100, dtype=np.float32) * 3}, step=3,
        kind="gpt-decode")
    assert r2["version"] == 2 and VersionRegistry(root).latest() == 2
    np.testing.assert_array_equal(
        CheckpointStore(root).restore(step=2)[0]["w"],
        np.arange(100, dtype=np.float32) * 3)


# ---------------------------------------------------------------------------
# PS exporter: cadence + pub_* verbs on the PS wire
# ---------------------------------------------------------------------------

def test_ps_exporter_publishes_on_cadence_and_serves_watch(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    pub_dir = str(tmp_path / "pub")
    srv = PSServer("127.0.0.1:0", publish_dir=pub_dir,
                   publish_every_steps=3)
    srv.serve_in_thread()
    cl = PSClient([srv.endpoint])
    watcher = RegistryClient(srv.endpoint, timeout=30.0)
    seen = []
    stop = watcher.watch(seen.append)
    try:
        rng = np.random.RandomState(1)
        for i in range(3):
            cl.push("emb", 8, np.arange(i * 4, i * 4 + 4),
                    rng.randn(4, 8))
        reg = VersionRegistry(pub_dir)
        assert _wait_for(lambda: reg.reload(missing_ok=True)
                         or reg.latest() >= 1)
        rec = reg.record_latest()
        assert rec["kind"] == "ps-table" and rec["digest"]
        assert rec["run"] == f"ps:{srv.endpoint}"
        # the published tables restore to EXACTLY the live state
        live = srv.tables["emb"].export_state()
        arrays, meta = CheckpointStore(pub_dir).restore(
            step=rec["version"])
        np.testing.assert_array_equal(arrays["k:emb"], live["keys"])
        np.testing.assert_array_equal(arrays["r:emb"], live["rows"])
        assert meta["tables"]["emb"]["dim"] == 8
        # pub_* verbs answer on the PS endpoint itself
        assert watcher.latest()["latest"] == rec["version"]
        # and the watch stream delivered the announce (or its
        # subscribe-ack catch-up record)
        assert _wait_for(
            lambda: any(r["version"] >= rec["version"] for r in seen))
    finally:
        stop.set()
        watcher.close()
        cl.close()
        srv.shutdown()
        srv.server_close()


def test_ps_without_publish_dir_rejects_pub_ops(tmp_path):
    srv = PSServer("127.0.0.1:0")
    srv.serve_in_thread()
    cli = RegistryClient(srv.endpoint, timeout=30.0)
    try:
        from paddle_tpu_torch.distributed.fleet.runtime.rpc import \
            PSRemoteError
        with pytest.raises(PSRemoteError, match="publishing not"):
            cli.latest()
    finally:
        cli.close()
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# background WAL replay
# ---------------------------------------------------------------------------

def _build_wal_server(snap_dir):
    """A WAL server with state split across a compacted base AND a
    journal tail (so a restart exercises both), including a lazily
    initialised row (RNG-stream coverage)."""
    srv = PSServer("127.0.0.1:0", snapshot_dir=snap_dir, wal=True)
    srv.wal_compact_bytes = 1500
    srv.serve_in_thread()
    cl = PSClient([srv.endpoint])
    rng = np.random.RandomState(3)
    for i in range(24):                   # crosses the compact bytes
        cl.push("emb", 8, [i], rng.randn(1, 8))
    assert srv.full_snapshots >= 1        # base npz committed
    cl.push("emb", 8, [100, 101], rng.randn(2, 8))   # journal tail
    cl.pull("emb", 8, [500])              # lazy init consumes the RNG
    cl.push("wide", 4, [5], rng.randn(1, 4))
    state = {n: t.export_state() for n, t in srv.tables.items()}
    ep = srv.endpoint
    cl.close()
    srv.shutdown()
    srv.server_close()
    return ep, state


def test_wal_bg_replay_state_parity_with_blocking(tmp_path,
                                                  monkeypatch):
    """Background replay reaches BIT-FOR-BIT the same state as blocking
    replay — rows, key order, RNG stream, and the re-armed dedup
    ids."""
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    snap = str(tmp_path / "snap")
    os.makedirs(snap)
    ep, live = _build_wal_server(snap)
    snap2 = str(tmp_path / "snap2")
    shutil.copytree(snap, snap2)

    # sequential restarts on the SAME endpoint (the snapshot + WAL
    # files are endpoint-tagged), each from its own copy of the dir
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
        assert set(block_state) == set(live) == set(bg.tables)
        for name, want in live.items():
            for got in (block_state[name],
                        bg.tables[name].export_state()):
                np.testing.assert_array_equal(want["keys"],
                                              got["keys"])
                np.testing.assert_array_equal(want["rows"],
                                              got["rows"])
                a, b = want["rng"], got["rng"]
                assert a["pos"] == b["pos"]
                assert a["has_gauss"] == b["has_gauss"]
                np.testing.assert_array_equal(a["key"], b["key"])
        assert block_dedup == len(bg._rpc.dedup._order) > 0
        # fresh lazy rows draw the SAME init stream on both
        np.testing.assert_array_equal(
            block_fresh, bg.tables["emb"].pull(np.array([888])))
    finally:
        bg.server_close()


def test_wal_bg_replay_gate_serves_stale_reads(tmp_path, monkeypatch):
    """During background replay: pulls whose rows already exist come
    back immediately and stale-marked; a pull that would CREATE a row
    (and consume the table RNG out of journal order) blocks until
    replay finishes, then returns the exact post-replay value."""
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    snap = str(tmp_path / "snap")
    os.makedirs(snap)
    ep, live = _build_wal_server(snap)

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
        # base-resident rows answer NOW, flagged stale
        vals = cl.pull("emb", 8, [0, 1, 2])
        assert cl.last_pull_stale and cl.stale_pulls == 1
        np.testing.assert_array_equal(
            vals, live["emb"]["rows"][:3])
        # a row only the journal tail holds: blocked behind the gate
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
        assert not th.is_alive()
        assert srv._replay_done.is_set()
        assert got["stale"] is False              # post-replay: fresh
        idx = list(live["emb"]["keys"]).index(100)
        np.testing.assert_array_equal(got["v"][0],
                                      live["emb"]["rows"][idx])
        # gate lifted: reads are not stale-marked any more
        cl.pull("emb", 8, [0])
        assert cl.last_pull_stale is False and cl.stale_pulls == 1
    finally:
        release.set()
        cl.close()
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# multi-host manifest merge
# ---------------------------------------------------------------------------

_PART_CHILD = """
import json, sys, numpy as np
from paddle_tpu_torch.checkpoint.store import CheckpointStore
root, rank, world, step = (sys.argv[1], int(sys.argv[2]),
                           int(sys.argv[3]), int(sys.argv[4]))
st = CheckpointStore(root, chunk_bytes=1024)
rng = np.random.RandomState(rank)
state = {f"r{rank}.w": rng.randn(40, 8).astype(np.float32),
         f"r{rank}.b": np.full((4,), rank, np.int64)}
st.save_part(state, step=step, rank=rank, world=world)
print(json.dumps({"rank": rank, "done": True}), flush=True)
"""


def test_manifest_merge_two_host_subprocess(tmp_path):
    """Two 'hosts' (real subprocesses) each publish their partial
    manifest; rank 0's merge is the single commit. A merge attempted
    while a rank is missing raises and leaves the previous version the
    restore target."""
    root = str(tmp_path)
    st = CheckpointStore(root, chunk_bytes=1024)
    st.save({"seed": np.arange(8)}, step=1)     # previous version

    def run_rank(rank):
        p = subprocess.run(
            [sys.executable, "-c", _PART_CHILD, root, str(rank), "2",
             "2"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["done"]

    run_rank(0)
    # only rank 0 published: merge must refuse, previous step survives
    with pytest.raises(manifest_mod.ManifestError, match="missing"):
        st.merge_parts(2, 2)
    assert manifest_mod.load_latest(root)["step"] == 1
    run_rank(1)
    assert st.merge_parts(2, 2, meta={"world": 2}) == 2
    arrays, meta = st.restore()
    assert meta == {"world": 2}
    assert sorted(arrays) == ["r0.b", "r0.w", "r1.b", "r1.w"]
    for rank in (0, 1):
        rng = np.random.RandomState(rank)
        np.testing.assert_array_equal(
            arrays[f"r{rank}.w"], rng.randn(40, 8).astype(np.float32))
        np.testing.assert_array_equal(
            arrays[f"r{rank}.b"], np.full((4,), rank, np.int64))
    # parts were consumed by the merge
    assert manifest_mod.list_parts(root, 2) == []


def test_merge_rejects_overlapping_and_corrupt_parts(tmp_path):
    root = str(tmp_path)
    st = CheckpointStore(root, chunk_bytes=1024)
    st.save_part({"x": np.zeros(4)}, step=5, rank=0, world=2)
    st.save_part({"x": np.ones(4)}, step=5, rank=1, world=2)
    with pytest.raises(manifest_mod.ManifestError, match="two ranks"):
        st.merge_parts(5, 2)
    # corrupt one part in place: CRC refuses it before anything commits
    st2 = CheckpointStore(root, chunk_bytes=1024)
    st2.save_part({"a": np.zeros(4)}, step=6, rank=0, world=2)
    st2.save_part({"b": np.ones(4)}, step=6, rank=1, world=2)
    path = manifest_mod.part_path(root, 6, 1)
    with open(path) as f:
        doc = json.load(f)
    doc["payload"]["arrays"]["b"]["nbytes"] = 999   # torn content
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(manifest_mod.ManifestError, match="CRC"):
        st2.merge_parts(6, 2)
    with pytest.raises(manifest_mod.ManifestError):
        manifest_mod.load_latest(root)    # still nothing committed


# ---------------------------------------------------------------------------
# metrics surface + the lock surface under concurrency
# ---------------------------------------------------------------------------

def test_publish_metrics_registered():
    from paddle_tpu_torch.observability.registry import REGISTRY
    for name in ("paddle_tpu_publish_publications_total",
                 "paddle_tpu_publish_rollbacks_total",
                 "paddle_tpu_publish_dedup_ratio",
                 "paddle_tpu_publish_seconds",
                 "paddle_tpu_publish_swap_seconds",
                 "paddle_tpu_publish_subscriber_lag_versions"):
        assert REGISTRY.get(name) is not None, name


def test_publish_module_concurrent_lock_surface(tmp_path):
    """The reference re-runs its module under its lock-order sanitizer
    (not ported). Here the same surface — publisher lock, registry lock,
    the lock-free single-flight doc write, watch queues — runs from
    four threads at once: publishers, a pin/rollback operator and a
    reloading watcher. Nothing may deadlock (each join has a timeout),
    every version number is taken once, and the doc on disk ends equal
    to the in-memory state."""
    root = str(tmp_path)
    pub = Publisher(root, store=CheckpointStore(root, chunk_bytes=1024,
                                                keep=0))
    reg = pub.registry
    sid, sub = reg.watch_queue()
    errors, recs = [], []

    def publisher(seed):
        try:
            rng = np.random.RandomState(seed)
            for _ in range(6):
                recs.append(pub.publish_arrays(
                    {"w": rng.randn(64).astype(np.float32)},
                    step=seed, kind="ps-table"))
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(repr(e))

    def operator():
        try:
            for _ in range(12):
                v = reg.latest()
                if v:
                    reg.pin(v)
                    if reg.versions() and len(reg.versions()) > 1:
                        reg.rollback()
                time.sleep(0.001)
        except Exception as e:   # noqa: BLE001
            errors.append(repr(e))

    def watcher():
        for _ in range(40):
            reg.reload(missing_ok=True)
            time.sleep(0.001)

    threads = [threading.Thread(target=publisher, args=(s,))
               for s in (1, 2)]
    threads += [threading.Thread(target=operator),
                threading.Thread(target=watcher)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads), "deadlock"
    assert not errors, errors
    versions = sorted(r["version"] for r in recs)
    assert versions == list(range(1, 13))
    cold = VersionRegistry(root)
    assert [r["version"] for r in cold.versions()] == versions
    assert cold.latest() == reg.latest() and cold.pinned() == reg.pinned()
    assert cold.rollbacks() == reg.rollbacks()
    assert sub.q.qsize() > 0
    reg.unwatch(sid)


# ---------------------------------------------------------------------------
# cross-package, bit for bit
# ---------------------------------------------------------------------------

def _payload_sans_time(reg_path):
    with open(reg_path, "rb") as f:
        doc = json.loads(f.read().decode("utf-8"))
    for rec in doc["payload"]["versions"].values():
        rec.pop("unix")
    return doc["format"], doc["payload"]


def test_parity_digest_manifest_and_registry_equal_across_packages(
        tmp_path):
    rng = np.random.RandomState(5)
    arrays = {"k:emb": np.arange(40, dtype=np.int64),
              "r:emb": rng.randn(40, 16).astype(np.float32),
              "b": rng.randn(3).astype(np.float64)}
    roots = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    recs = {}
    for name, cls in (("port", Publisher), ("ref", JPublisher)):
        pub = cls(roots[name], run="drill")
        recs[name] = [pub.publish_arrays(arrays, step=3, kind="ps-table",
                                         meta={"tables": {"emb": 16}}),
                      pub.publish_arrays(dict(arrays, b=arrays["b"] * 2),
                                         step=4, kind="ps-table")]
    for a, b in zip(recs["port"], recs["ref"]):
        assert a["digest"] == b["digest"] and a["version"] == b["version"]
        assert a["extra"] == b["extra"]
    for v in (1, 2):
        mp = CheckpointStore(roots["port"]).latest_manifest(v)
        mr = CheckpointStore(roots["ref"]).latest_manifest(v)
        assert mp == mr
        assert parity_digest(mp) == j_parity_digest(mr) \
            == recs["port"][v - 1]["digest"]
    assert _payload_sans_time(VersionRegistry(roots["port"]).path) \
        == _payload_sans_time(JRegistry(roots["ref"]).path)
    # each package's chunk files are the other's, byte for byte
    for d in ("port", "ref"):
        other = "ref" if d == "port" else "port"
        for dirpath, _dirs, files in os.walk(
                os.path.join(roots[d], "chunks")):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), roots[d])
                with open(os.path.join(roots[d], rel), "rb") as f1, \
                        open(os.path.join(roots[other], rel), "rb") as f2:
                    assert f1.read() == f2.read(), rel


def test_jax_registry_reads_the_ports_pin_and_rollbacks(tmp_path):
    root = str(tmp_path)
    pub = Publisher(root)
    for step in (10, 20, 30):
        pub.publish_arrays({"w": np.full(8, step, np.float32)}, step=step,
                           kind="gpt-decode")
    pub.registry.pin(2)
    pub.registry.rollback()               # to the pinned version
    pub.registry.rollback(to=1)
    ref = JRegistry(root)
    assert (ref.latest(), ref.pinned(), ref.rollbacks()) == (1, 2, 2)
    assert [r["step"] for r in ref.versions()] == [10, 20, 30]
    assert ref.get(3)["digest"] == pub.registry.get(3)["digest"]
    # and the port re-reads a registry the JAX package moved on
    ref.publish(4, step=40, kind="gpt-decode", digest="d4")
    again = VersionRegistry(root)
    assert again.latest() == 4 and again.pinned() == 2
    assert again.get(4)["digest"] == "d4"


@pytest.fixture(scope="module")
def gpt_tree():
    cfg_p = pgpt.GPTConfig(**SIZE)
    return pgpt.init_gpt_params(cfg_p, seed=0)


def test_port_subscriber_adopts_a_jax_publication(gpt_tree, tmp_path):
    """The JAX Publisher publishes a tiny GPTDecodeModel; the port's
    VersionSubscriber (file poll) adopts it into a port Engine that
    started on other weights. The adopted parameters equal the tree
    bit for bit, the greedy tokens equal a port model built on that tree
    exactly, and the JAX engine's (tie rule)."""
    root = str(tmp_path / "pub")
    cfg_j, cfg_p = jgpt.GPTConfig(**SIZE), pgpt.GPTConfig(**SIZE)
    jm = JModel(cfg_j, params=gpt_tree)
    rec = JPublisher(root).publish_model(jm, step=100)
    assert rec["version"] == 1 and rec["kind"] == "gpt-decode"
    other = GPTDecodeModel(cfg_p, params=pgpt.init_gpt_params(cfg_p,
                                                               seed=1),
                           device="cpu")
    eng = Engine(other, **ENGINE_KW)
    sub = VersionSubscriber(root, engine=eng, poll=0.05)
    sub.start()
    try:
        assert sub.current_version == 1 and sub.swaps == 1
        assert eng.stats()["model_version"] == 1
    finally:
        sub.stop()
    direct = GPTDecodeModel(cfg_p, params=gpt_tree, device="cpu")
    for k, v in direct.params.items():
        if k == "blocks":
            for got_b, want_b in zip(eng.model.params["blocks"], v):
                for name in want_b:
                    assert np.array_equal(got_b[name].numpy(),
                                          want_b[name].numpy()), name
        else:
            assert np.array_equal(eng.model.params[k].numpy(),
                                  v.numpy()), k
    reqs = [eng.submit(p, NEW) for p in PROMPTS]
    eng.run_until_idle()
    got = [r.result().tolist() for r in reqs]
    deng = Engine(direct, **ENGINE_KW)
    dreqs = [deng.submit(p, NEW) for p in PROMPTS]
    deng.run_until_idle()
    assert got == [r.result().tolist() for r in dreqs]
    jeng = JEngine(jm, **ENGINE_KW)
    jreqs = [jeng.submit(p, NEW) for p in PROMPTS]
    jeng.run_until_idle()
    for prompt, g, jr in zip(PROMPTS, got, jreqs):
        want = jr.result().tolist()
        if g == want:
            continue
        i = next(k for k in range(len(want)) if g[k] != want[k])
        ids = np.concatenate([prompt, want[:i]]).astype(np.int32)[None]
        logits = np.asarray(jgpt.gpt_forward(jm.params, jnp.asarray(ids),
                                             cfg_j))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < TIE_TOL, (prompt, g, want, top2)


def test_publish_model_chunks_equal_the_checkpoint_and_jax(gpt_tree,
                                                           tmp_path):
    """The port's publish_model writes the keys, flatten order and
    chunks of save_checkpoint (so publishing over a checkpoint store
    dedups completely) and of the JAX package's publish_model."""
    cfg_j, cfg_p = jgpt.GPTConfig(**SIZE), pgpt.GPTConfig(**SIZE)
    model = GPTDecodeModel(cfg_p, params=gpt_tree, device="cpu")
    root = str(tmp_path / "pub")
    model.save_checkpoint(root)
    pub = Publisher(root, store=CheckpointStore(root, keep=0))
    rec = pub.publish_model(model, step=5)
    assert rec["extra"]["dedup"] == 1.0 and pub.last_dedup_ratio == 1.0
    mine = CheckpointStore(root).latest_manifest(rec["version"])
    jroot = str(tmp_path / "jpub")
    jrec = JPublisher(jroot).publish_model(JModel(cfg_j,
                                                  params=gpt_tree), step=5)
    theirs = CheckpointStore(jroot).latest_manifest(jrec["version"])
    assert list(mine["arrays"]) == list(theirs["arrays"])
    assert mine["arrays"] == theirs["arrays"]
    assert rec["digest"] == jrec["digest"]


def test_ps_publications_equal_across_packages(tmp_path, monkeypatch):
    """Seeded pushes into both packages' publish-wired shards (numpy
    tables) publish equal table rows, keys and digests."""
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    out = {}
    for name, mod in (("port", None), ("ref", ref_ps)):
        server_cls = PSServer if mod is None else mod.PSServer
        client_cls = PSClient if mod is None else mod.PSClient
        pub_dir = str(tmp_path / name)
        srv = server_cls("127.0.0.1:0", publish_dir=pub_dir,
                         publish_every_steps=3)
        srv.serve_in_thread()
        cl = client_cls([srv.endpoint])
        try:
            rng = np.random.RandomState(7)
            reg = VersionRegistry(pub_dir)
            # each cadence's pushes land before the next begin, so the
            # two versions hold the same rows in both packages
            for i in range(3):
                cl.push("emb", 8, np.arange(i * 5, i * 5 + 6),
                        rng.randn(6, 8))
            assert _wait_for(lambda: reg.reload(missing_ok=True)
                             or reg.latest() >= 1)
            for i in range(3):
                cl.push("wide", 4, np.array([i, 40 + i]),
                        rng.randn(2, 4))
            assert _wait_for(lambda: reg.reload(missing_ok=True)
                             or reg.latest() >= 2)
            rec = reg.get(2)
            arrays, meta = CheckpointStore(pub_dir).restore(
                step=rec["version"])
            out[name] = (arrays, meta["tables"], rec["digest"])
        finally:
            cl.close()
            srv.shutdown()
            srv.server_close()
    (a_p, t_p, d_p), (a_r, t_r, d_r) = out["port"], out["ref"]
    assert sorted(a_p) == sorted(a_r) == ["k:emb", "k:wide", "r:emb",
                                          "r:wide"]
    for k in a_p:
        np.testing.assert_array_equal(a_p[k], a_r[k])
        assert a_p[k].dtype == a_r[k].dtype
    assert t_p == t_r and d_p == d_r
