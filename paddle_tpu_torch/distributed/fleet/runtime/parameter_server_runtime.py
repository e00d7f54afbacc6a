"""Parameter-server runtime — host-resident sharded KV over TCP
(counterpart of
``paddle_tpu/distributed/fleet/runtime/parameter_server_runtime.py``).

Reference chain: the `listen_and_serv` event loop
(operators/distributed_ops/listen_and_serv_op.cc:352), the gRPC/BRPC
transport, `large_scale_kv.h`'s in-memory sparse table and the fleet
runtime glue (distributed/fleet/runtime/parameter_server_runtime.py).
The tables stay host numpy behind the native C++ core
(``paddle_tpu_torch/native``), as in the JAX package; the card enters
the PS path at the workers (``fleet/fleet_wrapper.py`` DownpourWorker,
``fleet/heter_worker.py`` HeterDenseWorker). Shards route keys by hash
(``keys % shards``) over the fault-tolerant wire of ``rpc.py``
(data-only frames, optional HMAC handshake, no pickle on any receive
path), byte-identical to the JAX package's, so either package's client
talks to the other's shard.

Fault tolerance: clients retry with deadlines/backoff and stable request
ids; the shard dedups mutating ops, snapshots its tables, dedup ids and
RNG streams (base + delta npz files, interchangeable with the JAX
package's) through ``distributed/fs.py``, and
``PSServer.restart_from_snapshot`` resumes a killed shard so workers
reconnect instead of restarting the job.

Durability and high availability: with the row-level WAL on
(``wal=`` / PADDLE_PS_WAL) a push journals only its touched rows
(``checkpoint/wal.py``) and a restart replays base + journal; a shard
started with a primary endpoint is a hot standby fed by the primary's
journal over ``repl_watch`` (``ps_ha.py``: semi-sync acks, epoch
fencing, promotion, planned handoff), and a ``|``-joined group in
PSClient fails over to the promoted member with the same request ids;
``tier_warm_bytes`` holds warm rows in RAM under a byte budget and
demand-pages cold ones from a chunk store (``tiered_store.py``).
Journal records, replication streams and bootstraps are the JAX
package's bytes, so the two packages' shards replicate to each other.

Online learning and telemetry: with ``publish_dir`` (or
PADDLE_TPU_PUBLISH_DIR) the shard publishes its tables through the
publish tier (``paddle_tpu_torch/publish``) on a cadence and answers the
``pub_*`` registry verbs; PADDLE_TPU_TELEMETRY_HOST=1 makes it host a
telemetry collector answering the ``tel_*`` verbs, so one endpoint
serves pulls, version announces and the fleet's telemetry.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import re
import socketserver
import tempfile
import threading
import time
import weakref

import numpy as np

from ....observability import (debug as _debug, flight as _flight,
                               registry as _obs, watchdog as _watchdog)
from .fault_injection import injector
from .ps_ha import (ReplicationHub, StandbyReplicator, note_fenced_write,
                    note_handoff, note_promotion, set_role_gauges)
from .rpc import (PSDeadlineError, PSRemoteError, RpcClient,
                  RpcServerState, TransportStats, _hard_close,
                  serve_connection)

__all__ = ["ParameterServerRuntime", "LargeScaleKV", "PSServer", "PSClient"]

# snapshot-tier telemetry (per-op rpc latency/retries/dedup counters
# live in rpc.py; these cover the durability path's cost)
_SNAPSHOTS = _obs.counter(
    "paddle_tpu_ps_snapshots_total",
    "snapshot files written, by kind (base|delta)", ["kind"])
_SNAPSHOT_BYTES = _obs.counter(
    "paddle_tpu_ps_snapshot_bytes_total",
    "array payload bytes exported to snapshot files", ["kind"])
_SNAPSHOT_SECONDS = _obs.histogram(
    "paddle_tpu_ps_snapshot_write_seconds",
    "wall time of one snapshot file write", ["kind"])

# watchdog token uniqueness across same-endpoint server respawns
_ps_server_ids = itertools.count()


class LargeScaleKV:
    """In-memory sparse table (reference large_scale_kv.h).

    Hot path: the C++ open-addressing core in
    ``paddle_tpu_torch/native/kv_store.cc`` (id->slot hash + contiguous
    row arena, no Python per row). The vectorized numpy path runs when no
    toolchain is available or PADDLE_TPU_DISABLE_NATIVE is set; it also
    keeps the init RNG's state in snapshots, so rows created after a
    restore reproduce the original run bit for bit."""

    def __init__(self, dim: int, init_std: float = 0.01, seed: int = 0):
        self.dim = dim
        self.init_std = init_std
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self._index: dict[int, int] = {}
        self._data = np.empty((0, dim), np.float32)
        self._lock = threading.Lock()
        self._native = None
        if not os.environ.get("PADDLE_TPU_DISABLE_NATIVE"):
            from ....native import NativeKV, available
            if available():
                self._native = NativeKV(dim, init_std, seed)

    def _ensure(self, keys: np.ndarray) -> np.ndarray:
        """Slots for keys, creating missing rows in one batched init."""
        idx = self._index
        # dedup while preserving order: duplicate new keys in one batch
        # must allocate ONE slot (else start drifts off the data high-water
        # mark and later inserts clobber existing rows)
        missing = list(dict.fromkeys(
            k for k in keys.tolist() if k not in idx))
        if missing:
            start = len(idx)
            fresh = self._rng.normal(
                0, self.init_std,
                (len(missing), self.dim)).astype(np.float32)
            need = start + len(missing)
            if need > len(self._data):
                grow = np.empty((max(need, 2 * len(self._data) + 64),
                                 self.dim), np.float32)
                grow[:len(self._data)] = self._data
                self._data = grow
            self._data[start:start + len(missing)] = fresh
            for i, k in enumerate(missing):
                idx[k] = start + i
        return np.fromiter((idx[k] for k in keys.tolist()), np.int64,
                           len(keys))

    def pull(self, keys: np.ndarray) -> np.ndarray:
        with self._lock:
            if self._native is not None:
                return self._native.pull(keys)
            slots = self._ensure(np.asarray(keys).ravel())
            return self._data[slots].copy()

    def push(self, keys: np.ndarray, grads: np.ndarray, lr: float = 1.0):
        """SGD apply (reference async PS applies grads on arrival);
        duplicate keys accumulate."""
        with self._lock:
            if self._native is not None:
                self._native.push(keys, grads, lr)
                return
            slots = self._ensure(np.asarray(keys).ravel())
            np.add.at(self._data, slots,
                      (-lr * np.asarray(grads)).astype(np.float32))

    def rows_for(self, keys: np.ndarray) -> np.ndarray:
        """Current values of EXISTING rows (post-apply read for the WAL
        journal — O(len(keys)·dim), never O(table))."""
        with self._lock:
            ks = np.asarray(keys, np.int64).ravel()
            if self._native is not None:
                return self._native.pull(ks)
            slots = np.fromiter((self._index[int(k)]
                                 for k in ks.tolist()), np.int64,
                                len(ks))
            return self._data[slots].copy()

    def missing_keys(self, keys) -> np.ndarray | None:
        """Keys with no row yet, first-occurrence order (the exact set
        a pull would lazily init) — or None when unknown (the native
        core has no membership probe), meaning callers must assume
        all."""
        with self._lock:
            if self._native is not None:
                return None
            idx = self._index
            return np.fromiter(
                dict.fromkeys(k for k in np.asarray(keys, np.int64)
                              .ravel().tolist() if k not in idx),
                np.int64)

    def apply_rows(self, keys: np.ndarray, rows: np.ndarray):
        """WAL replay / replication apply: ensure the rows exist —
        consuming the init RNG stream exactly as the original apply did
        for then-missing keys — then assign the journaled post-values.
        Idempotent; replayed in append order from the same base it
        reproduces data, key→slot index and RNG stream bit for bit.
        (Native path: the pull creates missing rows through the native
        RNG, so its stream advances identically too; a native base
        restore is value-exact only, since base snapshots do not carry
        the native RNG's position.)"""
        with self._lock:
            ks = np.asarray(keys, np.int64).ravel()
            vals = np.asarray(rows, np.float32).reshape(len(ks),
                                                        self.dim)
            if self._native is not None:
                self._native.pull(ks)  # create via RNG, then overwrite
                self._native.import_(ks, vals)
                return
            slots = self._ensure(ks)
            self._data[slots] = vals

    def size(self) -> int:
        with self._lock:
            if self._native is not None:
                return self._native.size()
            return len(self._index)

    def export_state(self) -> dict:
        """Snapshot-ready state: keys/rows plus (numpy path) the RNG
        stream, so rows initialised AFTER a restore reproduce the
        original run bit-for-bit."""
        with self._lock:
            if self._native is not None:
                keys, rows = self._native.export()
                rng = None
            else:
                keys = np.fromiter(self._index, np.int64,
                                   len(self._index))
                slots = np.fromiter(self._index.values(), np.int64,
                                    len(self._index))
                rows = self._data[slots].copy()
                rng = self._rng.get_state()
        st = {"dim": self.dim, "init_std": self.init_std,
              "seed": self.seed, "keys": keys, "rows": rows}
        if rng is not None:
            st["rng"] = {"alg": rng[0],
                         "key": np.asarray(rng[1], np.uint32),
                         "pos": int(rng[2]), "has_gauss": int(rng[3]),
                         "cached": float(rng[4])}
        return st

    def import_state(self, st: dict):
        with self._lock:
            self.dim = int(st["dim"])
            self.init_std = float(st.get("init_std", self.init_std))
            self.seed = int(st.get("seed", self.seed))
            keys = np.asarray(st["keys"], np.int64)
            rows = np.asarray(st["rows"], np.float32)
            if self._native is not None:
                from ....native import NativeKV
                # keep the instance seed so fresh rows created after a
                # restore stay reproducible
                self._native = NativeKV(self.dim, self.init_std,
                                        self.seed)
                if len(keys):
                    self._native.import_(keys, rows)
                return
            self._data = np.ascontiguousarray(rows)
            self._index = {int(k): i for i, k in enumerate(keys)}
            rng = st.get("rng")
            if rng is not None:
                self._rng.set_state((
                    str(rng["alg"]), np.asarray(rng["key"], np.uint32),
                    int(rng["pos"]), int(rng["has_gauss"]),
                    float(rng["cached"])))

    def save(self, path: str):
        """Persist as npz (data-only; loads with allow_pickle=False)."""
        st = self.export_state()
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, dim=np.int64(st["dim"]),
                     init_std=np.float64(st["init_std"]),
                     keys=st["keys"], rows=st["rows"])
        os.replace(tmp, path)

    def load(self, path: str):
        with np.load(path, allow_pickle=False) as blob:
            self.import_state({"dim": int(blob["dim"]),
                               "init_std": float(blob["init_std"]),
                               "keys": blob["keys"],
                               "rows": blob["rows"]})


class _SyncRound:
    """Sync-mode round state for one PS shard (reference
    RunSyncLoop + send_barrier/fetch_barrier rounds,
    operators/distributed/communicator.h:253 HalfAsync barrier logic):
    push_sync only BUFFERS gradients; the last trainer through the send
    barrier applies the whole round (mean over trainers) before anyone is
    released; the fetch barrier then holds the next round's apply until
    every trainer pulled the fresh values."""

    def __init__(self, trainers: int):
        self.trainers = trainers
        self.cond = threading.Condition()
        self.pending: list[tuple] = []
        self.send_done: set[int] = set()
        self.fetch_done: set[int] = set()
        self.round = 0
        self.fround = 0

    def push(self, item):
        with self.cond:
            self.pending.append(item)

    def send_barrier(self, worker: int, apply_fn) -> int:
        with self.cond:
            self.send_done.add(int(worker))
            if len(self.send_done) >= self.trainers:
                pending, self.pending = self.pending, []
                apply_fn(pending)
                self.send_done.clear()
                self.round += 1
                self.cond.notify_all()
                return self.round
            r = self.round
            if not self.cond.wait_for(lambda: self.round > r, timeout=300):
                raise TimeoutError("send_barrier: trainers missing")
            return self.round

    def fetch_barrier(self, worker: int) -> int:
        with self.cond:
            self.fetch_done.add(int(worker))
            if len(self.fetch_done) >= self.trainers:
                self.fetch_done.clear()
                self.fround += 1
                self.cond.notify_all()
                return self.fround
            fr = self.fround
            if not self.cond.wait_for(lambda: self.fround > fr,
                                      timeout=300):
                raise TimeoutError("fetch_barrier: trainers missing")
            return self.fround


class _DGCRound:
    """One sparse-gradient exchange round (DGC transport): trainers push
    their top-k (idx, val) pairs; once every trainer has pushed, pulls
    return the MERGED sparse gradient (duplicate indices summed,
    vectorized at seal time). The round recycles when every trainer has
    pulled — lockstep rounds like the reference's sparse allreduce.
    Stragglers raise TimeoutError (matching _SyncRound) instead of
    hanging the handler thread."""

    def __init__(self, trainers: int):
        self.trainers = trainers
        self.cond = threading.Condition()
        self._reset()

    def _reset(self):
        self.parts: list = []
        self.pushed: set[int] = set()
        self.pulled: set[int] = set()
        self.merged = None

    def push(self, worker: int, idx, val):
        with self.cond:
            if not self.cond.wait_for(
                    lambda: worker not in self.pushed, timeout=300):
                raise TimeoutError(
                    "dgc round not drained — a trainer never pulled")
            self.parts.append((np.asarray(idx, np.int64).ravel(),
                               np.asarray(val, np.float32).ravel()))
            self.pushed.add(worker)
            if len(self.pushed) == self.trainers:
                allidx = np.concatenate([p[0] for p in self.parts])
                allval = np.concatenate([p[1] for p in self.parts])
                uniq, inv = np.unique(allidx, return_inverse=True)
                summed = np.bincount(inv, weights=allval,
                                     minlength=len(uniq))
                self.merged = (uniq, summed.astype(np.float32))
                self.cond.notify_all()
            return True

    def pull(self, worker: int):
        with self.cond:
            if not self.cond.wait_for(lambda: self.merged is not None,
                                      timeout=300):
                raise TimeoutError(
                    "dgc round incomplete — trainers missing: "
                    f"{sorted(set(range(self.trainers)) - self.pushed)}")
            idx, val = self.merged
            self.pulled.add(worker)
            if len(self.pulled) == self.trainers:
                self._reset()
                self.cond.notify_all()
            return {"idx": idx, "val": val}


class _InvalSub:
    """One subscriber's invalidation feed: a bounded event queue plus
    an overflow set of tables owed a WHOLE-table invalidation (losing
    an event must degrade to over-invalidation, never staleness)."""

    def __init__(self, maxsize: int):
        self.q: queue.Queue = queue.Queue(maxsize)
        self.lost: set[str] = set()
        self.lock = threading.Lock()


class PSServer(socketserver.ThreadingTCPServer):
    """One PS shard: serves pull/push/save/size for its tables (reference
    listen_and_serv_op RunAsyncLoop — apply-on-arrival, no global
    barrier; RunSyncLoop when the sync ops are used). Port 0 binds an
    ephemeral port; `endpoint` reports it.

    Graceful degradation: with `snapshot_dir` set (arg or
    PADDLE_PS_SNAPSHOT_DIR), the shard snapshots its tables + dedup
    state every `snapshot_every` applied pushes (and every
    `snapshot_interval` seconds) and restores them on construction, so
    a killed shard resumes via `restart_from_snapshot` while clients
    retry-reconnect. Recovery covers the async push path; sync/DGC
    round state is volatile by design (those jobs restart the round).

    `wal` (PADDLE_PS_WAL) journals each push's touched rows and makes
    every snapshot a full base that compacts the journal;
    `wal_bg_replay` serves pulls of restored rows while the journal
    replays. `primary` (PADDLE_PS_HA_PRIMARY) makes the shard a hot
    standby of that endpoint, `ha_epoch` (PADDLE_PS_HA_EPOCH) is its
    fencing epoch. `tier_warm_bytes` / `tier_store_dir` /
    `tier_tables` (PADDLE_PS_TIER_*) tier the named tables.
    `publish_dir` (PADDLE_TPU_PUBLISH_DIR) publishes the tables on the
    `publish_every_{steps,seconds,rows}` cadence
    (PADDLE_TPU_PUBLISH_EVERY_*); PADDLE_TPU_TELEMETRY_HOST=1 hosts a
    telemetry collector on this shard's wire."""

    allow_reuse_address = True
    daemon_threads = True

    # ops that never mutate server state: exempt from dedup caching
    # (subscribe_inval only touches the subscriber registry — replaying
    # a subscription must open a fresh stream, never a cached reply).
    # The set is the JAX package's, verbs of later items included, so
    # both packages' shards dedup alike.
    READ_OPS = frozenset({"pull", "size", "ping", "lost_workers",
                          "heartbeat", "metrics", "debug_dump",
                          "subscribe_inval", "pub_latest", "pub_get",
                          "pub_list", "pub_watch",
                          "tel_push", "tel_ping", "tel_fleet",
                          "tel_trace", "tel_traces", "tel_stats",
                          "tel_watch", "tsdb_query", "alerts",
                          "usage_report",
                          "repl_watch", "repl_ack", "ha_status"})
    # mutating ops whose effects the snapshot tier persists
    _SNAPSHOT_OPS = frozenset({"push", "send_barrier"})
    # verbs that legitimately block on straggler trainers (or, for
    # subscribe_inval, sit open for the subscriber's lifetime): they
    # never count as in-flight work for the stall watchdog (a barrier
    # waiting out a slow trainer is round semantics, not a wedged
    # server)
    _BLOCKING_OPS = frozenset({"send_barrier", "fetch_barrier",
                               "dgc_push", "dgc_pull",
                               "subscribe_inval", "pub_watch",
                               "tel_watch",
                               # replication streams sit open for the
                               # standby's lifetime; handoff blocks on
                               # standby catch-up by design
                               "repl_watch", "ha_handoff"})
    # ops a standby (or a fenced ex-primary) still answers: liveness,
    # observability, the replication/ack plane, and promotion itself
    _HA_CTRL_OPS = frozenset({"ping", "metrics", "debug_dump",
                              "heartbeat", "lost_workers", "ha_status",
                              "ha_promote", "repl_ack", "repl_watch"})

    def __init__(self, endpoint: str, worker_timeout: float = 60.0,
                 snapshot_dir: str | None = None,
                 snapshot_every: int | None = None,
                 snapshot_interval: float | None = None,
                 secret: str | None = None, fs=None,
                 auto_restore: bool = True,
                 wal: bool | None = None,
                 wal_bg_replay: bool | None = None,
                 publish_dir: str | None = None,
                 publish_every_steps: int | None = None,
                 publish_every_seconds: float | None = None,
                 publish_every_rows: int | None = None,
                 primary: str | None = None,
                 ha_epoch: int | None = None,
                 tier_warm_bytes: int | None = None,
                 tier_store_dir: str | None = None,
                 tier_tables=None):
        env = os.environ.get
        host, port = endpoint.rsplit(":", 1)
        self.tables: dict[str, LargeScaleKV] = {}
        self._tables_lock = threading.Lock()
        self._sync: _SyncRound | None = None
        self._sync_lock = threading.Lock()
        # worker liveness (reference operators/distributed/
        # heart_beat_monitor.h:54): last-seen stamp per worker id;
        # lost_workers() reports ids silent past the timeout
        self.worker_timeout = worker_timeout
        self._beats: dict[int, float] = {}
        self._dgc: dict[str, _DGCRound] = {}
        self._beats_lock = threading.Lock()
        # hot-row invalidation pub/sub: every applied push publishes
        # {table, keys} to each subscriber's bounded queue; the
        # subscribe_inval stream drains it over server-push frames. A
        # queue overflow degrades to a whole-table invalidation marker
        # instead of dropping keys silently.
        self._inval_lock = threading.Lock()
        self._inval_subs: dict[int, _InvalSub] = {}
        self._inval_ids = itertools.count()
        self._inval_queue_max = int(env("PADDLE_PS_INVAL_QUEUE", "1024")
                                    or 0)
        self.inval_published = 0   # events fanned out (tests/bench)

        self.snapshot_dir = snapshot_dir \
            if snapshot_dir is not None \
            else (env("PADDLE_PS_SNAPSHOT_DIR") or None)
        self.snapshot_every = snapshot_every \
            if snapshot_every is not None \
            else int(env("PADDLE_PS_SNAPSHOT_EVERY", "64") or 0)
        self.snapshot_interval = snapshot_interval \
            if snapshot_interval is not None \
            else float(env("PADDLE_PS_SNAPSHOT_INTERVAL", "0") or 0)
        self.snapshot_compact_every = int(
            env("PADDLE_PS_SNAPSHOT_COMPACT_EVERY", "64") or 0)
        # row-level WAL tier: with wal on, a push journals only its
        # touched ROWS (checkpoint/wal.py) and durability is
        # write-through by construction; full base snapshots happen
        # only at the compaction threshold. Restore = base + journal
        # replay. Opt-in (PADDLE_PS_WAL / wal=True) — the delta-npz
        # tier stays the default.
        self.wal_enabled = wal if wal is not None \
            else env("PADDLE_PS_WAL", "") not in ("", "0")
        self.wal_compact_bytes = int(
            env("PADDLE_PS_WAL_COMPACT_BYTES", str(64 << 20)) or 0)
        if self.wal_enabled and not self.snapshot_dir:
            raise ValueError(
                "PADDLE_PS_WAL needs a snapshot dir "
                "(PADDLE_PS_SNAPSHOT_DIR) for its base snapshots")
        self._wal = None
        self._wal_pending = False
        # tiered embedding store: opt-in per server; tables named in
        # tier_tables (every table when empty) hold warm rows in RAM
        # under the byte budget and demand-page cold rows from a local
        # chunk store. Snapshots/WAL/HA are unchanged: TieredTable
        # exports materialize cold rows, so every downstream consumer
        # sees flat keys/rows state.
        self.tier_warm_bytes = int(
            tier_warm_bytes if tier_warm_bytes is not None
            else env("PADDLE_PS_TIER_WARM_BYTES", "0") or 0)
        tt = tier_tables if tier_tables is not None \
            else env("PADDLE_PS_TIER_TABLES", "")
        self.tier_tables = {s.strip() for s in tt.split(",")
                            if s.strip()} \
            if isinstance(tt, str) else set(tt)
        self.tier_store_dir = tier_store_dir \
            if tier_store_dir is not None \
            else (env("PADDLE_PS_TIER_STORE_DIR") or None)
        if self.tier_warm_bytes > 0 and not self.tier_store_dir:
            if not self.snapshot_dir:
                raise ValueError(
                    "PADDLE_PS_TIER_WARM_BYTES needs a cold-store "
                    "dir (PADDLE_PS_TIER_STORE_DIR, or a snapshot "
                    "dir to default under)")
            self.tier_store_dir = os.path.join(self.snapshot_dir,
                                               "tier_store")
        self.tier_demote_interval = float(
            env("PADDLE_PS_TIER_DEMOTE_INTERVAL", "0.05") or 0)
        self._tier_store = None  # lazy CheckpointStore
        self._tier_lock = threading.Lock()
        # high-availability plane: a shard started with a primary
        # endpoint is a hot STANDBY — it rejects normal traffic with
        # not_primary and tracks the primary row for row over the
        # repl_watch stream until promoted. The shard epoch fences
        # zombie ex-primaries: any request carrying a NEWER epoch
        # proves a successor exists, so this instance fences itself and
        # rejects writes with stale_epoch.
        self.ha_primary = primary if primary is not None \
            else (env("PADDLE_PS_HA_PRIMARY") or None)
        self.ha_role = "standby" if self.ha_primary else "primary"
        self.shard_epoch = int(ha_epoch if ha_epoch is not None
                               else env("PADDLE_PS_HA_EPOCH", "0")
                               or 0)
        self._ha_fenced = False
        self._ha_replicator: StandbyReplicator | None = None
        self._ha_replicated_bytes = 0
        self._ha: ReplicationHub | None = None  # built once port bound
        if fs is None:
            from ...fs import LocalFS
            fs = LocalFS()
        self._fs = fs
        self._snap_lock = threading.Lock()
        self._snap_io_lock = threading.Lock()  # one snapshot writer
        # apply+dedup-commit vs snapshot-export atomicity: concurrent
        # pushes and the exporter share this RLock (engaged only when
        # snapshots are on — commit_scope returns None otherwise), so a
        # restored snapshot can never hold an applied push without its
        # dedup id or vice versa. RLock: the snapshot hook itself runs
        # inside a push's commit scope.
        self._apply_lock = threading.RLock()
        self._snap_seq = 0       # exports, monotone (under apply lock)
        self._snap_written = 0   # newest BASE seq on disk (under io lock)
        self._mutations = 0
        # dirty-table tracking: pushes mark their table dirty; a
        # snapshot exports ONLY dirty tables into a delta file unless a
        # full base is due (first snapshot / compaction)
        self._dirty: set[str] = set()
        self._base_written = False
        self._deltas_since_base = 0
        self._last_export_mutations = -1
        self._snap_pending = False   # a DUE snapshot failed; retry owes it
        # exports taken but not yet on disk (seqs, under _snap_lock): a
        # snapshot returns only once every export up to its own is
        # written (see snapshot())
        self._unwritten: set[int] = set()
        self._written = threading.Condition(self._snap_lock)
        self.snapshots_taken = 0
        self.full_snapshots = 0
        self.delta_snapshots = 0
        # fleet-telemetry hosting: this shard answers the tel_* verbs
        # (collector role) when PADDLE_TPU_TELEMETRY_HOST=1, so small
        # fleets need no separate collector process
        self._tel_collector = None
        if env("PADDLE_TPU_TELEMETRY_HOST", "") == "1":
            from ....observability.collector import TelemetryCollector
            self._tel_collector = TelemetryCollector()
        self._rpc = RpcServerState(read_ops=self.READ_OPS,
                                   secret=secret,
                                   after_commit=self._after_commit,
                                   commit_scope=self._commit_scope,
                                   after_retry=self._after_retry,
                                   before_reply=self._ha_before_reply)
        # every live handler socket, so server_close/kill can sever
        # them (replication subscribers + inval streams included —
        # peers must see EOF now, not after a full recv timeout)
        self._conns_lock = threading.Lock()
        self._conns: weakref.WeakSet = weakref.WeakSet()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                with outer._conns_lock:
                    outer._conns.add(self.request)
                serve_connection(self.request, outer._dispatch,
                                 outer._rpc)

        super().__init__((host, int(port)), Handler)
        self.endpoint = f"{host}:{self.server_address[1]}"
        self._ha = ReplicationHub(self.endpoint)
        set_role_gauges(self.endpoint, self.ha_role, self.shard_epoch)
        # stall watchdog: completed dispatches are this shard's
        # progress counter; the shard is idle while no non-barrier op
        # is in flight, so a quiet server never looks stalled but a
        # wedged dispatch (hung disk, poisoned lock) fires the token.
        # The name carries a unique instance id: a respawned server on
        # the SAME endpoint must not have its token popped when the
        # old instance's finalize runs at GC.
        self._wd_lock = threading.Lock()
        self._wd_inflight = 0
        self._wd_done = 0
        self._wd_name = (f"ps.server.{self.endpoint.replace(':', '_')}"
                         f".{next(_ps_server_ids)}")
        _srv_ref = weakref.ref(self)
        _watchdog.WATCHDOG.watch(
            self._wd_name,
            probe=lambda: (lambda s: None if s is None
                           else s._wd_done)(_srv_ref()),
            idle=lambda: (lambda s: True if s is None
                          else s._wd_inflight == 0)(_srv_ref()))
        weakref.finalize(self, _watchdog.WATCHDOG.unwatch,
                         self._wd_name)
        if auto_restore and self.snapshot_dir \
                and self._fs.is_file(self.snapshot_path):
            self.load_snapshot()
            self._base_written = True
        # WAL replay gate: set = fully caught up. Background replay
        # clears it so the shard SERVES during replay — pulls of rows
        # the base/partial replay already holds come back stale-marked,
        # everything else (mutations, row-creating pulls) waits on the
        # event in _replay_gate. Default stays blocking replay
        # (construction returns caught-up).
        self._replay_done = threading.Event()
        self._replay_done.set()
        self.wal_bg_replay = wal_bg_replay if wal_bg_replay is not None \
            else env("PADDLE_PS_WAL_BG_REPLAY", "") not in ("", "0")
        if self.wal_enabled:
            # replay runs even with NO base on disk: before the first
            # compaction the journal alone holds the whole history
            if auto_restore and self.wal_bg_replay:
                self._replay_done.clear()
                # journal hook armed NOW: it no-ops while _wal is None,
                # and every mutating op is gated until _open_wal ran,
                # so no mutation can slip through un-journaled
                self._rpc.journal = self._journal
                threading.Thread(target=self._bg_replay, daemon=True,
                                 name="ps-wal-replay").start()
            else:
                if auto_restore:
                    self._replay_wal()
                self._open_wal()
                self._rpc.journal = self._journal
        # continuous publication: route table exports through the
        # publish tier's content-addressed store on a cadence; the
        # pub_* registry verbs ride this server's own wire
        self.publish_dir = publish_dir if publish_dir is not None \
            else (env("PADDLE_TPU_PUBLISH_DIR") or None)
        self._publisher = None
        self._exporter = None
        if self.publish_dir:
            from ....publish import PSExporter, Publisher
            self._publisher = Publisher(
                self.publish_dir,
                run=f"ps:{self.endpoint}")
            self._exporter = PSExporter(
                self, self._publisher,
                every_steps=publish_every_steps,
                every_seconds=publish_every_seconds,
                every_rows=publish_every_rows).start()
        self._snap_stop = threading.Event()
        if self.snapshot_dir and self.snapshot_interval > 0:
            threading.Thread(target=self._snapshot_loop,
                             daemon=True).start()
        if self.ha_role == "standby":
            self._ha_replicator = StandbyReplicator(
                self, self.ha_primary).start()

    def _bg_replay(self):
        """Background WAL replay (PADDLE_PS_WAL_BG_REPLAY): identical
        work to the blocking path — same journal files, same order,
        same dedup re-arming — just behind the read-through gate
        instead of in front of serve_forever. The finally guarantees a
        replay crash still unwedges gated clients (they see the
        table state the partial replay reached; the WAL files are
        still on disk for the next restart)."""
        try:
            self._replay_wal()
        finally:
            try:
                # arm journaling even after a partial replay: appends
                # land after the torn tail recover=True truncated, the
                # same state a blocking restart would reach
                self._open_wal()
            except Exception:
                pass
            self._replay_done.set()

    def serve_in_thread(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th

    def server_close(self):
        self._snap_stop.set()
        with self._tables_lock:
            ts = list(self.tables.values())
        for t in ts:
            close = getattr(t, "close", None)
            if close is not None:
                close()  # stop tiered tables' demoter threads
        rep = self._ha_replicator
        if rep is not None:
            rep.close()
        if self._exporter is not None:
            self._exporter.stop()
        if self._wal is not None:
            self._wal.close()
        super().server_close()
        # sever every live handler socket: replication subscribers and
        # inval streams must see EOF NOW, so a standby detects primary
        # death within its heartbeat interval, not after a full recv
        # timeout
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            _hard_close(s)

    def kill(self):
        """Stop serving AND sever every open connection — the
        in-process stand-in for shard death (chaos drills): attached
        standbys see the stream break immediately."""
        self.shutdown()
        self.server_close()

    # -- snapshot/recovery tier ----------------------------------------
    @property
    def snapshot_path(self) -> str | None:
        if not self.snapshot_dir:
            return None
        tag = self.endpoint.replace(":", "_")
        return os.path.join(self.snapshot_dir, f"ps_{tag}.snap.npz")

    def _commit_scope(self, op: str):
        # only the non-blocking async mutations take the shared lock;
        # barrier/DGC dispatch blocks on straggler trainers and their
        # round state is volatile by design (not snapshot-covered)
        if op == "push" and self.snapshot_dir:
            return self._apply_lock
        if op == "ha_handoff":
            # handoff IS the drain: dispatching under the apply lock
            # means every in-flight push has committed + journaled
            # before the catch-up wait, and new pushes queue on the
            # lock — after the epoch flip they dispatch against a
            # demoted server, get not_primary, and redirect with the
            # SAME request id (zero failed pushes)
            return self._apply_lock
        return None

    def _ha_before_reply(self, op: str, req_id: int):
        """RPC-layer hook between dedup commit and reply: semi-sync
        replication holds the push's ack here — OUTSIDE the commit
        scope, so a waiting push never serializes other pushes."""
        if op in self._SNAPSHOT_OPS and self._ha is not None \
                and self._ha.semisync > 0:
            self._ha.wait_semisync(req_id)

    def _after_commit(self, op: str):
        if op not in self._SNAPSHOT_OPS:
            return
        if self._exporter is not None:
            # cadence counters + wake event only — publication IO
            # never runs on the push path
            self._exporter.note_commit(op)
        with self._snap_lock:
            self._mutations += 1
            if self._wal is not None:
                # WAL mode: durability already happened (the journal
                # hook ran inside the commit scope); the only disk work
                # owed here is threshold compaction into a fresh base
                due = bool(self._wal_pending
                           or (self.wal_compact_bytes
                               and self._wal.bytes_written
                               >= self.wal_compact_bytes))
                full = True
            else:
                due = bool(self.snapshot_dir and self.snapshot_every
                           and self._mutations % self.snapshot_every
                           == 0)
                full = None
        if due:
            # _wal_pending is cleared inside snapshot() at rotation
            # time (under the apply lock) — clearing HERE would erase a
            # flag set concurrently by another push's journal failure
            # after our export captured state
            self.snapshot(full=full)

    def _after_retry(self, op: str):
        """Dedup-hit retry of a mutating op: the original after_commit
        may have died mid-snapshot (failed export/write re-merged the
        dirty marks and raised before the reply). Finish that owed
        persistence WITHOUT counting a new mutation. Keyed on the
        explicit failure flag — a merely-dirty table under a stride/
        interval policy (snapshot_every=N>1) is NOT owed a snapshot,
        so flaky-link retries cannot degrade N-stride configs to
        write-through IO."""
        if op not in self._SNAPSHOT_OPS or not self.snapshot_dir:
            return
        with self._snap_lock:
            pending = self._snap_pending or self._wal_pending
        if pending:
            # WAL mode: a failed journal append leaves rows whose exact
            # apply ORDER is unrecoverable — a full base (which rotates
            # the journal and clears _wal_pending under the apply lock)
            # recaptures everything including RNG streams
            self.snapshot(full=True if self._wal is not None else None)

    def _snapshot_loop(self):
        while not self._snap_stop.wait(self.snapshot_interval):
            self.snapshot()

    # -- row-level WAL tier (checkpoint/wal.py) --------------------------
    def _wal_path(self, stamp: int) -> str:
        tag = self.endpoint.replace(":", "_")
        return os.path.join(self.snapshot_dir,
                            f"ps_{tag}.wal_{stamp:010d}")

    def _wal_files(self) -> list[tuple[int, str]]:
        """(stamp, path) of every journal on LOCAL disk, by stamp. The
        WAL is a local-disk tier (os.open append path) — remote-fs
        deployments keep bases remote and journals beside the shard."""
        tag = self.endpoint.replace(":", "_")
        prefix = f"ps_{tag}.wal_"
        out = []
        try:
            names = os.listdir(self.snapshot_dir)
        except FileNotFoundError:
            return []
        for f in names:
            if f.startswith(prefix):
                try:
                    out.append((int(f[len(prefix):]),
                                os.path.join(self.snapshot_dir, f)))
                except ValueError:
                    continue
        return sorted(out)

    def _make_journal(self, path: str, recover: bool = False):
        """Every journal on an HA-capable server is a ReplicatedJournal:
        with no subscribers attached the publish is a few dict ops, and
        the moment a standby subscribes it sees records in exactly
        journal append order."""
        from .ps_ha import ReplicatedJournal
        return ReplicatedJournal(path, self._ha, recover=recover)

    def _open_wal(self):
        os.makedirs(self.snapshot_dir, exist_ok=True)
        files = self._wal_files()
        stamp = max(files[-1][0] if files else 0, self._snap_written)
        # recover=True: truncate any torn tail left by the previous
        # incarnation BEFORE appending — records written after garbage
        # would sit beyond every future replay's stop point
        self._wal = self._make_journal(self._wal_path(stamp),
                                       recover=True)

    def _rotate_wal(self, seq: int):
        """Start journal wal_<seq> (records from now on replay on top
        of base seq). Called under the apply lock at base-export time;
        the superseded journals are deleted only once that base COMMITS
        (_write_snapshot_files), so a failed base write loses nothing."""
        from ....checkpoint.wal import RowJournal
        old, self._wal = self._wal, self._make_journal(
            self._wal_path(seq))
        if old is not None:
            old.close()
        RowJournal.note_compaction()
        # tell standbys we folded the journal into a fresh base so
        # they re-anchor (compact their own journal) too
        self._wal.publish_rotate(seq)

    def _replay_wal(self):
        """Rebuild state journaled after the restored base: apply each
        committed rows-record (ensure+assign — idempotent for rows the
        base already holds) and re-arm the dedup cache from journaled
        request ids, so a client retrying across the crash still gets
        exactly-once. Stops cleanly at a torn tail (the crash point)."""
        from ....checkpoint.wal import replay_file
        from .rpc import decode_body
        replayed = 0
        for _stamp, path in self._wal_files():
            for rec in replay_file(path):
                if rec["kind"] == "rows":
                    t = self.table(rec["table"], int(rec["dim"]),
                                   float(rec.get("init_std", 0.01)))
                    t.apply_rows(rec["idx"], rec["values"])
                rid = int(rec.get("req_id", 0))
                if rid:
                    reply = decode_body(rec["extra"]) \
                        if rec["extra"] else True
                    self._rpc.dedup.commit(rid, reply)
                    with self._snap_lock:
                        self._mutations += 1
                replayed += 1
        return replayed

    def _wal_guard(self, append):
        """Run one journal append under the owed-durability contract:
        on failure the mutation is applied (and possibly dedup'd) but
        NOT on disk — flag it so the retry/after_commit hooks recover
        with a full base snapshot (which re-captures the un-journaled
        rows/RNG and rotates the journal), and re-raise so the client
        sees the failure."""
        try:
            return append()
        except BaseException:
            with self._snap_lock:
                self._wal_pending = True
            raise

    def _tier_pull(self, t, keys):
        """Pull with cold-fault accounting: a tiered table reports how
        many rows it demand-paged, and a faulting reply is wrapped
        ``{"v": rows, "cold_faults": n}`` (the replay-gate dict-reply
        precedent) so PSClient can count cold faults per pull."""
        pull_ex = getattr(t, "pull_ex", None)
        if pull_ex is None:
            return t.pull(keys)
        out, faults = pull_ex(keys)
        if faults:
            return {"v": out, "cold_faults": int(faults)}
        return out

    def _wal_pull(self, req: dict):
        """WAL-mode pull. Hot path (every key already has a row): only
        the per-table lock, same as non-WAL mode. A pull that must
        lazily init rows consumes the table RNG, so the created rows
        are journaled — under the apply lock, because the
        create+journal pair must serialize against pushes or replay
        order could diverge from allocation order."""
        t = self.table(req["table"], req["dim"],
                       req.get("init_std", 0.01))
        probe = t.missing_keys(req["keys"])
        if probe is not None and len(probe) == 0:
            # cold faults (tiered tables) happen HERE, off the apply
            # lock — paging in an existing row creates nothing and
            # consumes no RNG, so it needs no journaling
            return self._tier_pull(t, req["keys"])
        with self._apply_lock:
            missing = t.missing_keys(req["keys"])  # re-check under lock
            n0 = t.size()
            out = self._tier_pull(t, req["keys"])
            if missing is not None:
                created = missing
            elif t.size() != n0:  # native: no membership probe —
                created = np.asarray(req["keys"],  # journal full set
                                     np.int64).ravel()
            else:
                created = np.empty(0, np.int64)
            if len(created):
                # journal ONLY the created rows (O(created), not
                # O(pulled)); replay's ensure+assign re-draws the init
                # stream at the same point
                self._mark_dirty(req["table"])
                self._wal_guard(lambda: self._wal.append_rows(
                    req["table"], created, t.rows_for(created),
                    dim=t.dim, init_std=t.init_std, seed=t.seed))
        return out

    def _journal(self, op: str, req: dict, req_id: int, reply):
        """RpcServerState.journal hook — runs INSIDE the commit scope,
        right after the dedup commit. A push journals its touched rows'
        post-values; every other mutating op journals a dedup mark (its
        state effects are either volatile round state or journaled by
        the barrier apply itself)."""
        if self._wal is None:
            return
        from .rpc import encode_body
        if op == "push":
            t = self.tables[req["table"]]
            keys = np.asarray(req["keys"], np.int64).ravel()
            self._wal_guard(lambda: self._wal.append_rows(
                req["table"], keys, t.rows_for(keys), dim=t.dim,
                init_std=t.init_std, seed=t.seed, req_id=req_id,
                extra=encode_body(reply)))
            _flight.record("ps", "wal_commit", endpoint=self.endpoint,
                           op=op, table=req.get("table"),
                           rows=int(keys.size), req_id=req_id)
        else:
            self._wal_guard(lambda: self._wal.append_mark(
                req_id, extra=encode_body(reply)))
            _flight.record("ps", "wal_commit", endpoint=self.endpoint,
                           op=op, rows=0, req_id=req_id)


    def _delta_path(self, seq: int) -> str:
        tag = self.endpoint.replace(":", "_")
        return os.path.join(self.snapshot_dir,
                            f"ps_{tag}.delta_{seq:010d}.npz")

    def _delta_files(self) -> list[tuple[int, str]]:
        """(seq, filename) of every delta on storage, sorted by seq."""
        tag = self.endpoint.replace(":", "_")
        prefix, suffix = f"ps_{tag}.delta_", ".npz"
        _dirs, files = self._fs.ls_dir(self.snapshot_dir)
        out = []
        for f in files:
            if f.startswith(prefix) and f.endswith(suffix):
                try:
                    out.append((int(f[len(prefix):-len(suffix)]), f))
                except ValueError:
                    continue
        return sorted(out)

    def snapshot(self, full: bool | None = None):
        """Consistent table+dedup snapshot. Runs before the mutating
        reply is sent (`after_commit` hook), so a crash between apply
        and reply still resolves to exactly-once: the retried request
        hits the restored dedup set.

        Incremental tier: the first snapshot (and every
        `snapshot_compact_every`-th thereafter) writes the full base
        npz; in between, a snapshot writes a DELTA npz holding only the
        tables dirtied since the previous export, plus the
        dedup/mutation state, so write-through durability
        (PADDLE_PS_SNAPSHOT_EVERY=1) costs O(touched-table bytes) per
        push instead of O(all-table bytes). Restore = base + deltas in
        sequence order; base writes garbage-collect superseded deltas.

        Locking: the EXPORT runs under `_apply_lock` (tables, dirty
        set, and dedup ids must come from the same instant, or a
        crash-restore could double-apply or drop a concurrent worker's
        push); the npz write runs under `_snap_io_lock` only, so
        concurrent pushes proceed during disk IO. Lock order is always
        apply -> io (the push-commit path enters here already holding
        the apply RLock). A slow older BASE writer is kept from
        clobbering a newer base by the sequence check; delta files are
        per-seq, so late writes cannot clobber anything and the
        seq-ordered replay at load time makes write order irrelevant.

        Known benign race: before the FIRST base write lands on disk,
        concurrent exporters each see _base_written=False and export a
        redundant full base (the io-side seq check discards all but
        the newest). Deciding the base optimistically instead would let
        a racing DELTA land on disk with no base beneath it, turning a
        crash in that window into real data loss.

        Ordering: a push's rows can ride an EARLIER export than its own
        (another pusher's export ran after this push applied), and a
        restore replays only the deltas on disk. So a snapshot returns,
        and the reply goes out, only once every export up to its own
        is written; one that finds nothing new waits for the newest
        export in flight: otherwise a kill between the two writes loses
        an acknowledged push."""
        path = self.snapshot_path
        if path is None:
            return
        with self._apply_lock:
            with self._snap_lock:
                dirty = set(self._dirty)
                self._dirty.clear()
            if full is not True and self._base_written and not dirty \
                    and self._mutations == self._last_export_mutations:
                # nothing changed since the last export: an idle server
                # on a snapshot_interval timer must not churn empty
                # deltas (or periodic full bases) forever. That export
                # holds this state, but may still be in its writer
                seq = None
                upto = self._snap_seq
            else:
                self._snap_seq += 1
                seq = upto = self._snap_seq
                try:
                    if self._wal is not None:
                        # WAL mode has no deltas: every snapshot is a
                        # full base that compacts the journal. Rotate
                        # FIRST (still under the apply lock): rows
                        # applied after this instant land in wal_<seq>,
                        # which is exactly what replays on top of base
                        # seq. Any owed persistence (_wal_pending) is
                        # satisfied by this export — clearing it under
                        # the apply lock means a journal failure racing
                        # us either happened before (rows captured by
                        # this export) or will set the flag after we
                        # clear it (kept for the next base)
                        do_full = True
                        self._rotate_wal(seq)
                        with self._snap_lock:
                            self._wal_pending = False
                    else:
                        do_full = full if full is not None else (
                            not self._base_written
                            or (self.snapshot_compact_every
                                and self._deltas_since_base
                                >= self.snapshot_compact_every))
                    arrays = self._export_arrays(
                        seq, names=None if do_full else dirty,
                        kind="base" if do_full else "delta")
                    self._last_export_mutations = self._mutations
                except BaseException:
                    with self._snap_lock:
                        self._dirty |= dirty
                        self._snap_pending = True
                    raise
                with self._snap_lock:
                    self._unwritten.add(seq)
        if seq is not None:
            try:
                self._write_snapshot_files(path, arrays, seq, do_full)
            except BaseException:
                # the dirty marks were consumed by this export; a failed
                # export/write must put them back (and flag the owed
                # snapshot for the retry hook) or every later delta
                # would silently omit these tables until the next base
                with self._snap_lock:
                    self._dirty |= dirty
                    self._snap_pending = True
                    self._unwritten.discard(seq)
                    self._written.notify_all()
                raise
            with self._snap_lock:
                self._snap_pending = False
                self._unwritten.discard(seq)
                self._written.notify_all()
        self._wait_written(upto)

    def _wait_written(self, upto: int):
        """Block until no export up to seq `upto` is still being
        written. If one of them failed (its dirty marks are back and a
        snapshot is owed), take that snapshot here: the caller's reply
        must not go out on state that is not on disk."""
        with self._written:
            while any(s <= upto for s in self._unwritten):
                self._written.wait()
            owed = self._snap_pending
        if owed:
            self.snapshot(full=True if self._wal is not None else None)

    def _write_snapshot_files(self, path, arrays, seq, do_full):
        kind = "base" if do_full else "delta"
        t0 = time.perf_counter()
        with self._snap_io_lock:
            if do_full:
                if seq <= self._snap_written:
                    # a newer base already reached disk; our dirty set
                    # is covered by it (exported later = superset state)
                    return
                self._write_snapshot(path, arrays)
                self._snap_written = seq
                self._base_written = True
                self._deltas_since_base = 0
                self.full_snapshots += 1
                for dseq, fname in self._delta_files():
                    if dseq <= seq:
                        self._fs.delete(
                            os.path.join(self.snapshot_dir, fname))
                if self._wal is not None:
                    # journals superseded by this base (their rows are
                    # all ≤ the base's export instant)
                    for wseq, wpath in self._wal_files():
                        if wseq < seq:
                            try:
                                os.unlink(wpath)
                            except OSError:
                                pass
            else:
                self._write_snapshot(self._delta_path(seq), arrays)
                self._deltas_since_base += 1
                self.delta_snapshots += 1
            self.snapshots_taken += 1
        if do_full and self._tier_store is not None:
            # fold the cold store's garbage in with base compaction:
            # chunks no live segment references (age-guarded, so a
            # segment mid-write is never collected) are dropped here
            from .tiered_store import gc_cold_store
            with self._tables_lock:
                ts = list(self.tables.values())
            gc_cold_store(self._tier_store, ts)
        dt = time.perf_counter() - t0
        nbytes = sum(a.nbytes for a in arrays.values())
        _SNAPSHOT_SECONDS.labels(kind=kind).observe(dt)
        _SNAPSHOTS.labels(kind=kind).inc()
        _SNAPSHOT_BYTES.labels(kind=kind).inc(nbytes)
        _flight.record("ps", "snapshot", endpoint=self.endpoint,
                       kind=kind, seq=seq, bytes=int(nbytes),
                       seconds=round(dt, 6))

    def _export_arrays(self, seq: int = 0, names: set | None = None,
                       kind: str = "base") -> dict:
        arrays: dict[str, np.ndarray] = {}
        meta = {"version": 2, "kind": kind, "seq": seq,
                "endpoint": self.endpoint,
                "mutations": self._mutations, "tables": {}}
        with self._tables_lock:
            items = [(n, t) for n, t in self.tables.items()
                     if names is None or n in names]
        for name, t in items:
            st = t.export_state()
            tmeta = {"dim": st["dim"], "init_std": st["init_std"],
                     "seed": st["seed"]}
            arrays[f"k:{name}"] = st["keys"]
            arrays[f"r:{name}"] = st["rows"]
            rng = st.get("rng")
            if rng is not None:
                tmeta["rng"] = {"alg": rng["alg"], "pos": rng["pos"],
                                "has_gauss": rng["has_gauss"],
                                "cached": rng["cached"]}
                arrays[f"s:{name}"] = rng["key"]
            meta["tables"][name] = tmeta
        ids, blobs = self._rpc.dedup.export()
        arrays["dedup_ids"] = ids
        arrays["dedup_lens"] = np.array([len(b) for b in blobs],
                                        np.int64)
        arrays["dedup_blob"] = np.frombuffer(
            b"".join(blobs), np.uint8) if blobs else \
            np.empty(0, np.uint8)
        arrays["meta"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), np.uint8)
        return arrays

    def _write_snapshot(self, path: str, arrays: dict):
        from ...fs import LocalFS
        self._fs.mkdirs(self.snapshot_dir)
        if isinstance(self._fs, LocalFS):
            # fast path: write beside the target, atomic rename
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            self._fs.mv(tmp, path, overwrite=True)
            return
        # remote fs (HDFSClient &co): stage locally, upload, rename
        fd, local = tempfile.mkstemp(suffix=".snap.npz")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            remote_tmp = f"{path}.tmp"
            self._fs.delete(remote_tmp)
            self._fs.upload(local, remote_tmp)
            self._fs.mv(remote_tmp, path, overwrite=True)
        finally:
            if os.path.exists(local):
                os.unlink(local)

    def load_snapshot(self, path: str | None = None):
        """Restore base + every delta with a newer sequence number, in
        sequence order (each delta replaces the tables it names and the
        full dedup/mutation state it captured — last write wins)."""
        base_meta = self._load_one(path or self.snapshot_path,
                                   replace=True)
        last_seq = int(base_meta.get("seq", 0))
        if self.snapshot_dir:
            for dseq, fname in self._delta_files():
                if dseq <= last_seq:
                    continue
                self._load_one(os.path.join(self.snapshot_dir, fname),
                               replace=False)
                last_seq = dseq
        with self._apply_lock:
            self._snap_seq = max(self._snap_seq, last_seq)
        self._snap_written = max(self._snap_written,
                                 int(base_meta.get("seq", 0)))

    def _load_one(self, path: str, replace: bool) -> dict:
        from ...fs import LocalFS
        local = path
        staged = None
        if not isinstance(self._fs, LocalFS):
            fd, staged = tempfile.mkstemp(suffix=".snap.npz")
            os.close(fd)
            os.unlink(staged)  # fs.download copies onto a fresh path
            self._fs.download(path, staged)
            local = staged
        try:
            with np.load(local, allow_pickle=False) as blob:
                return self._import_snapshot_blob(blob, replace)
        finally:
            if staged and os.path.exists(staged):
                os.unlink(staged)

    def _import_snapshot_blob(self, blob, replace: bool = True) -> dict:
        """Import one exported state blob (an open npz file, or the
        same arrays as a plain dict — the HA bootstrap arrives as a dict
        over the wire) into tables + dedup + mutation count."""
        meta = json.loads(bytes(blob["meta"]).decode("utf-8"))

        def writable(a):
            # wire-decoded arrays (HA bootstrap) view read-only
            # frombuffer memory; tables update rows in place
            a = np.asarray(a)
            return a if a.flags.writeable else a.copy()

        tables: dict[str, LargeScaleKV] = {}
        for name, tmeta in meta["tables"].items():
            t = self._make_table(name, int(tmeta["dim"]),
                                 init_std=float(tmeta["init_std"]),
                                 seed=int(tmeta["seed"]))
            st = {"dim": tmeta["dim"],
                  "init_std": tmeta["init_std"],
                  "seed": tmeta["seed"],
                  "keys": writable(blob[f"k:{name}"]),
                  "rows": writable(blob[f"r:{name}"])}
            if "rng" in tmeta:
                st["rng"] = dict(tmeta["rng"],
                                 key=writable(blob[f"s:{name}"]))
            t.import_state(st)
            tables[name] = t
        ids = blob["dedup_ids"]
        lens = blob["dedup_lens"].tolist()
        raw = blob["dedup_blob"].tobytes()
        blobs, off = [], 0
        for n in lens:
            blobs.append(raw[off:off + n])
            off += n
        with self._tables_lock:
            if replace:
                old, self.tables = self.tables, tables
            else:
                self.tables.update(tables)
                old = {}
        for t in old.values():
            # replaced tiered tables must stop their demoter threads
            close = getattr(t, "close", None)
            if close is not None:
                close()
        self._rpc.dedup.import_(ids, blobs)
        with self._snap_lock:
            self._mutations = int(meta.get("mutations", 0))
        return meta

    @classmethod
    def restart_from_snapshot(cls, endpoint: str, snapshot_dir: str,
                              **kwargs) -> "PSServer":
        """Bring a killed shard back on its endpoint, restoring tables,
        dedup ids, and RNG streams from the latest snapshot (workers'
        retry loops reconnect on their own)."""
        return cls(endpoint, snapshot_dir=snapshot_dir,
                   auto_restore=True, **kwargs)

    def _tier_store_handle(self):
        """Lazy shared CheckpointStore for every tiered table's cold
        segments (content-addressed chunks dedup across tables)."""
        with self._tier_lock:
            if self._tier_store is None:
                from ....checkpoint.store import CheckpointStore
                os.makedirs(self.tier_store_dir, exist_ok=True)
                self._tier_store = CheckpointStore(self.tier_store_dir,
                                                   keep=0)
            return self._tier_store

    def _make_table(self, name: str, dim: int, init_std: float = 0.01,
                    seed: int = 0) -> LargeScaleKV:
        if self.tier_warm_bytes > 0 and (
                not self.tier_tables or name in self.tier_tables):
            from .tiered_store import TieredTable
            return TieredTable(
                dim, init_std=init_std, seed=seed,
                store=self._tier_store_handle(), name=name,
                warm_bytes=self.tier_warm_bytes,
                demote_interval=self.tier_demote_interval)
        return LargeScaleKV(dim, init_std=init_std, seed=seed)

    def table(self, name: str, dim: int,
              init_std: float = 0.01) -> LargeScaleKV:
        with self._tables_lock:
            if name not in self.tables:
                self.tables[name] = self._make_table(name, dim,
                                                     init_std)
            return self.tables[name]

    def _mark_dirty(self, name: str):
        with self._snap_lock:
            self._dirty.add(name)

    # -- hot-row invalidation pub/sub -----------------------------------
    def _publish_inval(self, table: str, keys):
        """Fan an applied push's {table, keys} out to every subscriber.
        Non-blocking: a full queue records the table in the
        subscriber's overflow set (-> whole-table invalidation) so a
        slow subscriber can never stall the push path."""
        with self._inval_lock:
            subs = list(self._inval_subs.values())
        if not subs:
            return
        keys = np.asarray(keys, np.int64).ravel().copy()
        ev = {"table": table, "keys": keys}
        for s in subs:
            try:
                s.q.put_nowait(ev)
            except queue.Full:
                with s.lock:
                    s.lost.add(table)
        self.inval_published += 1

    def _subscribe_inval(self):
        """Dispatch generator for the subscribe_inval op: registers a
        subscriber and streams its events as server-push frames until
        the client cancels (F_CANCEL -> GeneratorExit) or disconnects.
        Keepalive frames every few seconds keep the stream's cancel
        check live while the shard is idle."""
        sub = _InvalSub(self._inval_queue_max)
        with self._inval_lock:
            sid = next(self._inval_ids)
            self._inval_subs[sid] = sub
        try:
            yield {"subscribed": True}
            while True:
                with sub.lock:
                    lost, sub.lost = sub.lost, set()
                for t in sorted(lost):
                    yield {"table": t, "full": True}
                try:
                    ev = sub.q.get(timeout=5.0)
                except queue.Empty:
                    yield {"keepalive": True}
                    continue
                yield ev
        finally:
            with self._inval_lock:
                self._inval_subs.pop(sid, None)

    # -- high availability (ps_ha.py) -----------------------------------
    def _ha_gate(self, op: str, req_epoch: int):
        """Role/epoch admission check, before the op switch. Standbys
        answer only the control plane (everything else redirects via
        not_primary). A primary that sees a request carrying a NEWER
        epoch has proof a successor was promoted: it fences itself and
        rejects writes with stale_epoch — a zombie ex-primary can
        never fork the shard."""
        if self.ha_role == "standby":
            if op in self._HA_CTRL_OPS:
                return
            raise ValueError(
                f"not_primary primary={self.ha_primary or ''} "
                f"epoch={self.shard_epoch}")
        if req_epoch > self.shard_epoch and not self._ha_fenced:
            self._ha_fenced = True
            _flight.record("ps", "ha_fenced", endpoint=self.endpoint,
                           epoch=self.shard_epoch,
                           req_epoch=req_epoch)
        if self._ha_fenced and op not in self._HA_CTRL_OPS:
            if op not in self.READ_OPS:
                note_fenced_write(self.endpoint, op, req_epoch,
                                  self.shard_epoch)
            raise ValueError(f"stale_epoch epoch={self.shard_epoch}")

    def _repl_watch(self, req: dict):
        """Dispatch generator for repl_watch: one standby's replication
        feed. Subscribing and exporting the bootstrap state under the
        apply lock guarantees no record committed after the bootstrap
        can be missed (duplicates across the boundary are benign —
        the standby skips already-applied sequence numbers)."""
        # a bg-replaying primary applies journal records WITHOUT
        # publishing them — bootstrapping mid-replay would hand the
        # standby partial state with no stream to fill the rest
        self._replay_done.wait()
        if self._wal is None:
            raise ValueError(
                "repl_watch needs the WAL tier (PADDLE_PS_WAL=1 with "
                "a snapshot dir) on the primary")
        name = str(req.get("name", "?"))
        hub = self._ha
        sub = None
        try:
            with self._apply_lock:
                sub = hub.subscribe(name)
                arrays = self._export_arrays(self._snap_seq,
                                             names=None, kind="base")
                start_seq = hub.seq
                epoch = self.shard_epoch
            yield {"bootstrap": arrays, "seq": start_seq,
                   "epoch": epoch, "sub": sub.sid,
                   "primary": self.endpoint}
            _flight.record("ps", "ha_standby_attach",
                           endpoint=self.endpoint, peer=name,
                           seq=start_seq)
            inj = injector()
            while True:
                if sub.broken:
                    raise ValueError(
                        "replication queue overflow — resync")
                try:
                    rec = sub.q.get(timeout=5.0)
                except queue.Empty:
                    yield {"kind": "keepalive",
                           "epoch": self.shard_epoch}
                    continue
                if inj.active:
                    act = inj.repl_fault(int(rec.get("seq", 0)))
                    if act is not None:
                        action, delay = act
                        if action == "drop":
                            continue  # standby sees the gap -> resync
                        if action == "delay":
                            time.sleep(delay)
                        elif action == "corrupt" \
                                and rec.get("kind") == "rows":
                            bad = np.array(rec["values"], np.float32,
                                           copy=True)
                            if bad.size:
                                bad.flat[0] += 1.0
                            rec = dict(rec, values=bad)  # crc now lies
                yield rec
        finally:
            if sub is not None:
                hub.unsubscribe(sub)

    def _ha_import_bootstrap(self, arrays: dict, seq: int, epoch: int):
        """Standby: replace local state with the primary's bootstrap
        export (tables + RNG streams + dedup cache), adopt its epoch,
        and re-anchor our own journal with a fresh full base."""
        with self._apply_lock:
            self._import_snapshot_blob(arrays, replace=True)
            if epoch > self.shard_epoch:
                self.shard_epoch = int(epoch)
                set_role_gauges(self.endpoint, self.ha_role,
                                self.shard_epoch)
            self._ha_replicated_bytes = 0
        _flight.record("ps", "ha_bootstrap", endpoint=self.endpoint,
                       primary=self.ha_primary or "", seq=int(seq),
                       epoch=int(epoch))
        if self._wal is not None:
            self.snapshot(full=True)

    def _ha_apply_record(self, rec: dict):
        """Standby: apply one replicated journal record through the
        same ensure+assign path WAL replay uses, journal it to our OWN
        journal (so a promoted standby restarts from its own disk),
        and commit the request id + reply into the dedup cache —
        exactly-once is preserved across failover."""
        from .rpc import decode_body
        extra = b""
        if "extra" in rec and len(rec["extra"]):
            extra = np.asarray(rec["extra"], np.uint8).tobytes()
        kind = rec.get("kind")
        with self._apply_lock:
            n = 0
            if kind == "rows":
                t = self.table(rec["table"], int(rec["dim"]),
                               float(rec.get("init_std", 0.01)))
                idx = np.asarray(rec["idx"], np.int64).ravel()
                t.apply_rows(idx, rec["values"])
                self._mark_dirty(rec["table"])
                if self._wal is not None:
                    n = self._wal_guard(
                        lambda: self._wal.append_rows(
                            rec["table"], idx,
                            np.asarray(rec["values"], np.float32),
                            dim=int(rec["dim"]),
                            init_std=float(rec.get("init_std", 0.01)),
                            seed=int(rec.get("seed", 0)),
                            req_id=int(rec.get("req_id", 0)),
                            extra=extra))
                else:
                    idx_b = idx.nbytes
                    n = int(np.asarray(rec["values"]).nbytes + idx_b)
            elif kind == "mark":
                if self._wal is not None:
                    n = self._wal_guard(
                        lambda: self._wal.append_mark(
                            int(rec.get("req_id", 0)), extra=extra))
            rid = int(rec.get("req_id", 0))
            if rid:
                self._rpc.dedup.commit(
                    rid, decode_body(extra) if extra else True)
                with self._snap_lock:
                    self._mutations += 1
            self._ha_replicated_bytes += n

    def _ha_note_rotate(self):
        """Standby: the primary compacted its journal into a fresh
        base — compact ours too, so standby disk usage tracks the
        primary's bound."""
        if self._wal is not None:
            self.snapshot(full=True)

    def promote(self, epoch: int) -> dict:
        """Standby -> primary (launcher failover or handoff target):
        adopt the bumped epoch, stop replicating, start serving. On an
        already-primary server this only ratchets the epoch."""
        epoch = int(epoch)
        rep = self._ha_replicator
        applied = int(rep.applied_seq) if rep is not None \
            else int(self._ha.seq)
        if self.ha_role != "primary":
            # order matters: flip the role FIRST so the replicator
            # loop exits instead of resyncing, then sever its stream
            self.ha_role = "primary"
            self.ha_primary = None
            self._ha_replicator = None
            if rep is not None:
                rep.close()
            note_promotion(self.endpoint, max(self.shard_epoch, epoch))
        self.shard_epoch = max(self.shard_epoch, epoch)
        self._ha_fenced = False
        set_role_gauges(self.endpoint, "primary", self.shard_epoch)
        return {"role": "primary", "epoch": int(self.shard_epoch),
                "endpoint": self.endpoint, "applied_seq": applied}

    def _ha_demote(self, new_primary: str, epoch: int):
        """Handoff tail: this ex-primary becomes a standby of the
        freshly promoted target, so the shard keeps a hot spare."""
        self.shard_epoch = int(epoch)
        self.ha_primary = new_primary
        self.ha_role = "standby"
        self._ha_fenced = False
        set_role_gauges(self.endpoint, "standby", self.shard_epoch)
        self._ha_replicator = StandbyReplicator(
            self, new_primary).start()

    def _ha_handoff(self, req: dict) -> dict:
        """Planned handoff (maintenance / shard rebalancing): runs
        UNDER the apply lock (commit_scope), so every in-flight push
        has committed and journaled before the catch-up wait, and new
        pushes queue on the lock — after the flip they redirect to the
        new primary with their SAME request ids. Zero failed pushes."""
        target = str(req.get("target", ""))
        if self.ha_role != "primary":
            raise ValueError(
                f"not_primary primary={self.ha_primary or ''} "
                f"epoch={self.shard_epoch}")
        if self._wal is None:
            raise ValueError("ha_handoff needs the WAL tier")
        sub = self._ha.find(target)
        if sub is None:
            raise ValueError(
                f"ha_handoff: {target!r} is not an attached standby")
        last = self._ha.seq
        if not self._ha.wait_caught_up(
                sub, last, timeout=float(req.get("timeout", 30.0))):
            raise RuntimeError(
                f"ha_handoff: {target} did not catch up to seq "
                f"{last}")
        epoch_new = int(self.shard_epoch) + 1
        cl = RpcClient(target, timeout=10.0, deadline=15.0,
                       max_retries=1)
        try:
            st = cl.call({"op": "ha_promote", "epoch": epoch_new},
                         timeout=10.0)
        finally:
            cl.close()
        self._ha_demote(target, epoch_new)
        note_handoff(self.endpoint, target, epoch_new)
        return {"promoted": target, "epoch": epoch_new,
                "applied_seq": int(st.get("applied_seq", 0))
                if isinstance(st, dict) else 0}

    def ha_status(self) -> dict:
        rep = self._ha_replicator
        return {"role": self.ha_role,
                "epoch": int(self.shard_epoch),
                "endpoint": self.endpoint,
                "primary": self.ha_primary or "",
                "fenced": bool(self._ha_fenced),
                "applied_seq": int(rep.applied_seq)
                if rep is not None else int(self._ha.seq),
                "repl_seq": int(self._ha.seq),
                "resyncs": int(rep.resyncs) if rep is not None else 0,
                "synced": bool(rep.synced.is_set())
                if rep is not None else True,
                "standbys": self._ha.status(),
                "semisync_degraded": int(self._ha.degraded)}

    # -- dispatch -------------------------------------------------------
    def _dispatch(self, req: dict):
        """In-flight accounting wrapper around the op switch: arms the
        stall watchdog token (non-barrier ops only), applies the
        hang-injection stall point, and records push/pull flight
        events for the postmortem ring."""
        op = req.get("op")
        track = op not in self._BLOCKING_OPS
        if track:
            with self._wd_lock:
                self._wd_inflight += 1
        inj = injector()
        if inj.active:
            inj.maybe_stall("dispatch", "server")
        try:
            rep = self._dispatch_inner(req)
        finally:
            if track:
                with self._wd_lock:
                    self._wd_inflight -= 1
                    self._wd_done += 1
        if op in ("push", "pull"):
            _flight.record("ps", op, endpoint=self.endpoint,
                           table=req.get("table"),
                           keys=int(np.asarray(req["keys"]).size)
                           if "keys" in req else 0)
        return rep

    def _replay_gate(self, req: dict):
        """Read-through gate while background WAL replay rebuilds
        state. Pulls whose rows ALL exist already (base + replay so
        far) are served immediately, wrapped ``{"v": rows, "stale":
        True}`` so the client knows they predate catch-up. Everything
        that would perturb replay — mutations, and pulls that would
        lazily CREATE rows (row creation consumes the table RNG, so
        out-of-order creation would diverge from journal order) —
        waits on the replay-done event. Pure status reads (ping,
        metrics, ...) pass through. Returns a reply to short-circuit
        with, or None to fall through to the normal op switch."""
        op = req["op"]
        if op == "pull":
            t = self.tables.get(req.get("table"))
            if t is not None:
                probe = t.missing_keys(req["keys"])
                if probe is not None and len(probe) == 0:
                    return {"v": t.pull(req["keys"]), "stale": True}
            self._replay_done.wait()
            return None
        if op in ("ping", "size", "metrics", "debug_dump",
                  "heartbeat", "lost_workers", "subscribe_inval",
                  "tsdb_query", "alerts", "usage_report") \
                or op.startswith("pub_") or op.startswith("tel_"):
            return None
        self._replay_done.wait()
        return None

    def _dispatch_inner(self, req: dict):
        op = req["op"]
        # shard epoch rides the request skeleton (HA fencing); epoch 0
        # = legacy client, always admitted on an unfenced primary
        req_epoch = int(req.pop("_epoch", 0) or 0)
        if req_epoch or self._ha_fenced or self.ha_role != "primary":
            self._ha_gate(op, req_epoch)
        if op == "repl_watch":
            return self._repl_watch(req)
        if op == "repl_ack":
            return self._ha.ack(int(req.get("sub", -1)),
                                int(req.get("seq", 0)),
                                int(req.get("bytes", 0)),
                                float(req.get("t", 0.0)))
        if op == "ha_status":
            return self.ha_status()
        if op == "ha_promote":
            return self.promote(int(req.get("epoch", 0)))
        if op == "ha_handoff":
            return self._ha_handoff(req)
        if not self._replay_done.is_set():
            gated = self._replay_gate(req)
            if gated is not None:
                return gated
        if op.startswith("pub_"):
            # version-registry verbs ride the PS wire when publishing is
            # configured — one endpoint serves pulls AND version
            # announces, so serving subscribers need no extra connection
            if self._publisher is None:
                raise ValueError(
                    "publishing not configured on this shard "
                    "(set PADDLE_TPU_PUBLISH_DIR or publish_dir=)")
            from ....publish.registry import registry_dispatch
            return registry_dispatch(self._publisher.registry, req)
        if op.startswith("tel_") \
                or op in ("tsdb_query", "alerts", "usage_report"):
            # fleet-telemetry verbs (hosted collector): one PS endpoint
            # can double as the collector, the debug_dump / pub_*
            # hosting pattern
            if self._tel_collector is None:
                raise ValueError(
                    "telemetry collector not hosted on this shard "
                    "(set PADDLE_TPU_TELEMETRY_HOST=1)")
            from ....observability.collector import telemetry_dispatch
            return telemetry_dispatch(self._tel_collector, req)
        if op == "pull":
            if self._wal is not None:
                return self._wal_pull(req)
            t = self.table(req["table"], req["dim"],
                           req.get("init_std", 0.01))
            n0 = t.size()
            out = self._tier_pull(t, req["keys"])
            if self.snapshot_dir and t.size() != n0:
                # lazy row init consumed the table's rng stream — the
                # next delta must carry this table even without a push
                self._mark_dirty(req["table"])
            return out
        if op == "push":
            self.table(req["table"], req["dim"],
                       req.get("init_std", 0.01)).push(
                req["keys"], req["grads"], req.get("lr", 1.0))
            if self.snapshot_dir:
                self._mark_dirty(req["table"])
            self._publish_inval(req["table"], req["keys"])
            if self._exporter is not None:
                self._exporter.note_rows(
                    int(np.asarray(req["keys"]).size))
            return True
        if op == "save":
            tag = self.endpoint.replace(":", "_")
            with self._tables_lock:
                items = list(self.tables.items())
            for name, t in items:
                t.save(f"{req['dirname']}/{name}.{tag}.kv")
            return True
        if op == "size":
            t = self.tables.get(req["table"])
            return 0 if t is None else t.size()
        if op == "push_sync":
            self._sync_state(req["trainers"]).push(
                (req["table"], req["dim"], req["keys"], req["grads"],
                 req.get("lr", 1.0)))
            return True
        if op == "send_barrier":
            def apply_fn(pending):
                n = max(int(req["trainers"]), 1)
                for table, dim, keys, grads, lr in pending:
                    # mean over trainers: matches the single-process
                    # full-batch step when each trainer computes the mean
                    # loss of its batch shard
                    t = self.table(table, dim)
                    t.push(keys, grads, lr / n)
                    self._publish_inval(table, keys)
                    if self.snapshot_dir:
                        # sync-mode mutation: the post-barrier delta
                        # snapshot must carry these tables too
                        self._mark_dirty(table)
                    if self._wal is not None:
                        # rows-only record; the barrier's own journal
                        # mark (separate record) only preserves its
                        # reply. A crash between the two is still
                        # exactly-once: a retried barrier re-applies
                        # the VOLATILE pending buffer, which is empty
                        # after a restart because every acked
                        # push_sync dedups via its own mark (and an
                        # unacked one re-buffers exactly once).
                        ks = np.asarray(keys, np.int64).ravel()
                        self._wal_guard(
                            lambda ks=ks, t=t: self._wal.append_rows(
                                table, ks, t.rows_for(ks), dim=t.dim,
                                init_std=t.init_std, seed=t.seed))
            return self._sync_state(req["trainers"]).send_barrier(
                req["worker"], apply_fn)
        if op == "fetch_barrier":
            return self._sync_state(req["trainers"]).fetch_barrier(
                req["worker"])
        if op == "subscribe_inval":
            return self._subscribe_inval()
        if op == "ping":
            return "pong"
        if op == "metrics":
            # Prometheus exposition over this shard process's registry
            # (rpc counters, snapshot costs) — the PS scrape point
            return _obs.prometheus_text()
        if op == "debug_dump":
            # full postmortem bundle: the serving frontend's handler,
            # persisted shard-side when a debug dir is configured and
            # returned over the wire
            return _debug.dump_verb(req)
        if op == "heartbeat":
            with self._beats_lock:
                self._beats[int(req["worker"])] = time.time()
            return True
        if op == "lost_workers":
            return self.lost_workers()
        if op == "dgc_push":
            # sparse gradient round (DGC transport, reference dgc_op.h +
            # sparse allreduce in operators/collective): accumulate each
            # trainer's top-k (idx, val) pairs; seal when all arrived.
            # Timeouts propagate — serve_connection turns any dispatch
            # exception into an error frame instead of a dead socket
            return self._dgc_round(req["table"], int(req["trainers"])
                                   ).push(int(req["worker"]),
                                          req["idx"], req["val"])
        if op == "dgc_pull":
            return self._dgc_round(req["table"], int(req["trainers"])
                                   ).pull(int(req["worker"]))
        raise ValueError(f"unknown PS op {op!r}")

    def _dgc_round(self, table: str, trainers: int) -> _DGCRound:
        with self._sync_lock:
            r = self._dgc.get(table)
            if r is None:
                r = self._dgc[table] = _DGCRound(trainers)
            elif r.trainers != trainers:
                if r.pushed or r.pulled:
                    raise RuntimeError(
                        f"dgc trainer count changed mid-round on "
                        f"{table!r} ({r.trainers} -> {trainers})")
                r = self._dgc[table] = _DGCRound(trainers)
            return r

    def _sync_state(self, trainers: int) -> _SyncRound:
        with self._sync_lock:
            if self._sync is None:
                self._sync = _SyncRound(int(trainers))
            elif self._sync.trainers != int(trainers):
                st = self._sync
                with st.cond:
                    idle = not st.pending and not st.send_done and \
                        not st.fetch_done
                if not idle:
                    raise ValueError(
                        f"sync trainer count changed mid-round "
                        f"({st.trainers} -> {trainers}) with buffered "
                        f"state — restart the job cleanly")
                # a new job with a different world size: fresh round state
                self._sync = _SyncRound(int(trainers))
            return self._sync

    def lost_workers(self) -> list[int]:
        now = time.time()
        with self._beats_lock:  # handler threads insert concurrently
            beats = list(self._beats.items())
        return sorted(w for w, t in beats
                      if now - t > self.worker_timeout)


_NOT_PRIMARY_RE = re.compile(
    r"not_primary(?:\s+primary=(\S*))?(?:\s+epoch=(\d+))?")
_STALE_EPOCH_RE = re.compile(r"stale_epoch\s+epoch=(\d+)")


class PSClient:
    """Worker-side stub: key-hash routing across server shards (reference
    ps_dispatcher hash dispatch + Communicator send path), one
    fault-tolerant RpcClient channel per shard (retry with stable
    request ids, per-request deadlines, backoff — reference brpc
    channel timeout_ms/max_retry).

    HA: a shard entry may be a ``|``-joined member list,
    ``primary|standby[|standby2]``. Shard routing is unchanged (one
    ACTIVE endpoint per shard); on a dead or demoted active member the
    client probes the group, adopts the live primary with the highest
    epoch, and replays the in-flight call with the SAME request id —
    server dedup makes the retry exactly-once even across a
    failover."""

    # sync-mode barrier (and DGC round) calls legitimately block
    # server-side for up to 300s waiting on straggler trainers — their
    # per-attempt timeout must outlast that
    BARRIER_TIMEOUT = 340.0

    def __init__(self, endpoints: list[str], secret: str | None = None,
                 timeout: float | None = None,
                 deadline: float | None = None,
                 max_retries: int | None = None,
                 backoff: float | None = None):
        self._groups = [str(ep).split("|") for ep in endpoints]
        # active member per shard: shard count and key routing see ONE
        # endpoint per group, exactly the non-HA shape
        self.endpoints = [g[0] for g in self._groups]
        # wire + fault accounting shared across shard channels
        # (bench/diagnostics read .bytes_out/.bytes_in; robustness
        # tests read .stats)
        self.stats = TransportStats()
        self._client_kw = dict(stats=self.stats, secret=secret,
                               timeout=timeout, deadline=deadline,
                               max_retries=max_retries,
                               backoff=backoff)
        self._ha_lock = threading.RLock()
        self._cl_cache: dict[str, RpcClient] = {}
        self._clients = [self._client_for(ep)
                         for ep in self.endpoints]
        self._epochs = [0] * len(self._groups)  # newest epoch seen
        self.failovers = 0        # active-member switches on failure
        self.redirects = 0        # not_primary redirects followed
        self.fenced_rejects = 0   # stale_epoch answers seen
        # pulls answered stale-marked by a shard mid-background-replay
        # (read-through gate): values predate WAL catch-up. Count, not
        # content — training tolerates bounded staleness by design
        self.stale_pulls = 0
        self.last_pull_stale = False
        # rows the tiered store demand-paged to answer our pulls: cost
        # visibility for the cold tier
        self.cold_faults = 0
        self.last_pull_cold_faults = 0
        self._pool = None  # lazy persistent fan-out pool
        self._inval_stop: threading.Event | None = None
        self._inval_threads: list[threading.Thread] = []

    @property
    def bytes_out(self) -> int:
        return self.stats.bytes_out

    @property
    def bytes_in(self) -> int:
        return self.stats.bytes_in

    def _client_for(self, ep: str) -> RpcClient:
        with self._ha_lock:
            cl = self._cl_cache.get(ep)
            if cl is None:
                cl = self._cl_cache[ep] = RpcClient(
                    ep, **self._client_kw)
            return cl

    def _call(self, i: int, req: dict, **kw):
        if len(self._groups[i]) == 1:
            # non-HA shard: exactly the pre-HA code path
            return self._clients[i].call(req, **kw)
        return self._ha_call(i, req, **kw)

    # -- HA failover path ------------------------------------------------
    def _set_active(self, i: int, ep: str):
        with self._ha_lock:
            if ep not in self._groups[i]:
                self._groups[i].append(ep)
            self.endpoints[i] = ep
            self._clients[i] = self._client_for(ep)

    def _advance(self, i: int):
        with self._ha_lock:
            g = self._groups[i]
            cur = self.endpoints[i]
            j = (g.index(cur) + 1) % len(g) if cur in g else 0
            self._set_active(i, g[j])

    def _failover(self, i: int):
        """Probe the group for a live primary (short single-attempt
        ha_status calls) and adopt the one with the highest epoch;
        with none answering yet (promotion in flight) stay put — the
        caller's retry loop keeps probing until its deadline."""
        with self._ha_lock:
            group = list(self._groups[i])
            cur = self.endpoints[i]
        best_ep, best_epoch = None, -1
        for ep in group:
            if ep == cur:
                continue
            try:
                st = self._client_for(ep).call(
                    {"op": "ha_status"}, timeout=1.0, deadline=1.5,
                    max_retries=0)
            except Exception:
                continue
            if isinstance(st, dict) and st.get("role") == "primary" \
                    and not st.get("fenced"):
                e = int(st.get("epoch", 0))
                if e > best_epoch:
                    best_ep, best_epoch = ep, e
        with self._ha_lock:
            if best_ep is not None \
                    and best_epoch >= self._epochs[i]:
                self._epochs[i] = max(self._epochs[i], best_epoch)
                self._set_active(i, best_ep)
                self.failovers += 1
                _flight.record("ps_client", "ha_failover", shard=i,
                               endpoint=best_ep, epoch=best_epoch)
                return True
        return False

    def _ha_call(self, i: int, req: dict, timeout: float | None = None,
                 deadline: float | None = None, req_id=None, **kw):
        """Group-aware call: pin the request id up front so every
        retry — including against a freshly promoted standby — is the
        SAME request to the dedup cache; follow not_primary redirects;
        adopt newer epochs from stale_epoch answers; probe the group
        on transport failures. Bounded by the normal call deadline."""
        cl0 = self._clients[i]
        budget = deadline if deadline is not None else cl0.deadline
        deadline_ts = time.monotonic() + budget
        if req_id is None:
            req_id = cl0._next_id()
        barrier = req.get("op") in ("send_barrier", "fetch_barrier",
                                    "dgc_push", "dgc_pull")
        probe = float(os.environ.get(
            "PADDLE_PS_HA_PROBE", "2.0") or 2.0)
        last: Exception | None = None
        while True:
            with self._ha_lock:
                cl = self._clients[i]
                epoch = self._epochs[i]
            r = dict(req)
            if epoch:
                r["_epoch"] = epoch
            left = deadline_ts - time.monotonic()
            if left <= 0:
                raise PSDeadlineError(
                    f"PS {req.get('op')!r} failed across HA group "
                    f"{self._groups[i]}: {last}") from last
            if barrier:
                # barrier dispatch legitimately blocks on stragglers:
                # a short probing cycle would tear rounds apart
                cycle = min(left, (timeout or self.BARRIER_TIMEOUT)
                            + 5.0)
            else:
                cycle = min(left, max(probe, 0.2))
            try:
                if not barrier and "max_retries" not in kw:
                    # single attempt per cycle: the OUTER loop owns
                    # retries here, so a dead active member triggers a
                    # group probe NOW instead of burning the whole
                    # probe cycle in reconnect backoff against it
                    return cl.call(r, timeout=timeout, deadline=cycle,
                                   req_id=req_id, max_retries=0, **kw)
                return cl.call(r, timeout=timeout, deadline=cycle,
                               req_id=req_id, **kw)
            except PSRemoteError as e:
                msg = str(e)
                m = _NOT_PRIMARY_RE.search(msg)
                if m is not None:
                    self.redirects += 1
                    last = e
                    with self._ha_lock:
                        if int(m.group(2) or 0) > self._epochs[i]:
                            self._epochs[i] = int(m.group(2) or 0)
                    if m.group(1):
                        self._set_active(i, m.group(1))
                    else:
                        self._failover(i) or self._advance(i)
                    continue
                m = _STALE_EPOCH_RE.search(msg)
                if m is None:
                    raise
                self.fenced_rejects += 1
                last = e
                srv_epoch = int(m.group(1))
                with self._ha_lock:
                    behind = srv_epoch > self._epochs[i]
                    if behind:
                        # we were behind this server: adopt its epoch
                        # and retry it
                        self._epochs[i] = srv_epoch
                if not behind:
                    # the server is the stale one (zombie): find the
                    # successor primary
                    self._failover(i) or self._advance(i)
            except (PSDeadlineError, ConnectionError, OSError) as e:
                last = e
                if self._failover(i):
                    continue    # adopted a live primary: retry NOW
            time.sleep(0.05)

    def _route(self, keys: np.ndarray) -> np.ndarray:
        return (keys.astype(np.int64) % len(self.endpoints)).astype(np.int64)

    def _fanout(self, calls):
        """Dispatch shard RPCs concurrently over a persistent pool
        (reference Communicator's long-lived send threads); sequential
        round-trips would make latency N_shards x RTT."""
        if len(calls) <= 1:
            return [fn() for fn in calls]
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=len(self.endpoints),
                thread_name_prefix="ps-client")
        return list(self._pool.map(lambda fn: fn(), calls))

    def pull(self, table: str, dim: int, keys,
             init_std: float = 0.01) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        owner = self._route(keys)
        out = np.empty((len(keys), dim), np.float32)
        masks = [(i, owner == i) for i in range(len(self.endpoints))]
        masks = [(i, m) for i, m in masks if m.any()]
        res = self._fanout([
            (lambda i=i, m=m: self._call(i, {"op": "pull", "table": table,
                                             "dim": dim,
                                             "keys": keys[m],
                                             "init_std": init_std}))
            for i, m in masks])
        stale = False
        cold = 0
        for (i, m), r in zip(masks, res):
            if isinstance(r, dict):  # replay-gate / tiered-store reply
                stale = stale or bool(r.get("stale"))
                cold += int(r.get("cold_faults", 0))
                r = r["v"]
            out[m] = r
        if stale:
            self.stale_pulls += 1
        self.last_pull_stale = stale
        self.cold_faults += cold
        self.last_pull_cold_faults = cold
        return out

    def push(self, table: str, dim: int, keys, grads, lr: float = 1.0,
             sync: bool = False, trainers: int = 1,
             init_std: float = 0.01):
        keys = np.asarray(keys, np.int64).ravel()
        grads = np.asarray(grads, np.float32).reshape(len(keys), dim)
        owner = self._route(keys)
        op = "push_sync" if sync else "push"
        masks = [(i, owner == i) for i in range(len(self.endpoints))]
        self._fanout([
            (lambda i=i, m=m: self._call(i, {"op": op, "table": table,
                                             "dim": dim, "keys": keys[m],
                                             "grads": grads[m],
                                             "lr": lr,
                                             "trainers": trainers,
                                             "init_std": init_std}))
            for i, m in masks if m.any()])

    def send_barrier(self, worker: int, trainers: int):
        """Block until every trainer finished this round's pushes; the
        last arrival applies the buffered round (reference
        send_barrier round semantics)."""
        self._fanout([
            (lambda i=i: self._call(i, {"op": "send_barrier",
                                        "worker": worker,
                                        "trainers": trainers},
                                    timeout=self.BARRIER_TIMEOUT))
            for i in range(len(self.endpoints))])

    def fetch_barrier(self, worker: int, trainers: int):
        """Block until every trainer pulled the freshly applied params."""
        self._fanout([
            (lambda i=i: self._call(i, {"op": "fetch_barrier",
                                        "worker": worker,
                                        "trainers": trainers},
                                    timeout=self.BARRIER_TIMEOUT))
            for i in range(len(self.endpoints))])

    def size(self, table: str) -> int:
        return sum(self._call(i, {"op": "size", "table": table})
                   for i in range(len(self.endpoints)))

    def heartbeat(self, worker_id: int):
        """Liveness ping to every shard (reference HeartBeatMonitor's
        worker-side UPDATE)."""
        self._fanout([
            (lambda i=i: self._call(i, {"op": "heartbeat",
                                        "worker": worker_id}))
            for i in range(len(self.endpoints))])

    def lost_workers(self) -> list[int]:
        lost: set[int] = set()
        for i in range(len(self.endpoints)):
            lost.update(self._call(i, {"op": "lost_workers"}))
        return sorted(lost)

    def save(self, dirname: str):
        for i in range(len(self.endpoints)):
            self._call(i, {"op": "save", "dirname": dirname})

    def metrics(self, shard: int | None = None):
        """Prometheus text from one shard (or every shard when None) —
        scrape helper for the PS `metrics` verb."""
        if shard is not None:
            return self._call(shard, {"op": "metrics"})
        return {ep: self._call(i, {"op": "metrics"})
                for i, ep in enumerate(self.endpoints)}

    def debug_dump(self, shard: int | None = None,
                   write: bool = True):
        """Postmortem bundle from one shard (or every shard when None)
        — metrics, trace ring, flight rings, env. `write=True` also
        persists it shard-side into the shard's own
        PADDLE_TPU_DEBUG_DIR (the destination is never
        wire-controlled)."""
        req = {"op": "debug_dump", "write": bool(write)}
        if shard is not None:
            return self._call(shard, dict(req))
        return {ep: self._call(i, dict(req))
                for i, ep in enumerate(self.endpoints)}

    # -- hot-row invalidation subscription -------------------------------
    def subscribe_invalidations(self, callback) -> threading.Event:
        """Subscribe to every shard's push-invalidation stream over the
        multiplexed channel (the stream shares the shard channel with
        pulls/pushes — no extra connection). ``callback(table, keys)``
        fires per event from a background thread; ``keys`` is an int64
        array, or ``None`` for a whole-table invalidation (the server
        overflowed this subscriber's queue). Returns a stop Event —
        set it (or call ``close()``) to end the subscription; each
        stream's F_CANCEL then frees the server-side subscriber.

        Reconnect loop: a dead shard ends the stream with a transport
        error; the thread re-subscribes with backoff. Pushes applied
        while disconnected are not replayed: ``BoxPSWrapper.flush``'s
        refresh covers the training loop."""
        if self._inval_stop is not None and not self._inval_stop.is_set():
            raise RuntimeError("invalidation subscription already active")
        stop = threading.Event()
        self._inval_stop = stop
        self._inval_threads = [
            threading.Thread(target=self._inval_loop,
                             args=(i, callback, stop), daemon=True,
                             name=f"ps-inval-{i}")
            for i in range(len(self.endpoints))]
        for th in self._inval_threads:
            th.start()
        return stop

    def _inval_loop(self, i: int, callback, stop: threading.Event):
        while not stop.is_set():
            gen = None
            try:
                gen = self._clients[i].call_stream(
                    {"op": "subscribe_inval"},
                    timeout=30.0, stream_timeout=30.0)
                for ev in gen:
                    if stop.is_set():
                        return
                    if not isinstance(ev, dict):
                        continue
                    table = ev.get("table")
                    if table is None:   # subscribed/keepalive frames
                        continue
                    if ev.get("full"):
                        callback(table, None)
                    else:
                        callback(table,
                                 np.asarray(ev["keys"], np.int64))
            except Exception:
                pass   # shard down or stream stalled: resubscribe
            finally:
                if gen is not None:
                    try:
                        gen.close()   # sends F_CANCEL if mid-stream
                    except Exception:
                        pass
            stop.wait(0.5)

    # -- DGC sparse-gradient rounds (shard by index hash) ----------------
    def dgc_allreduce(self, name: str, idx, val, worker: int,
                      trainers: int):
        """Exchange top-k sparse gradients: push this worker's (idx,
        val), receive the all-trainer merged sparse gradient. Wire cost
        is O(k) both ways vs O(N) for a dense exchange — the DGC
        transport the dgc_momentum op's compression exists for."""
        idx = np.asarray(idx, np.int64).ravel()
        val = np.asarray(val, np.float32).ravel()
        owner = self._route(idx)
        calls = []
        for i in range(len(self.endpoints)):
            m = owner == i
            calls.append((lambda i=i, m=m: self._call(
                i, {"op": "dgc_push", "table": name, "idx": idx[m],
                    "val": val[m], "worker": worker,
                    "trainers": trainers},
                timeout=self.BARRIER_TIMEOUT)))
        # round failures (straggler timeout, trainer-count change)
        # surface as PSRemoteError from the error frame
        self._fanout(calls)
        parts = self._fanout([
            (lambda i=i: self._call(i, {"op": "dgc_pull", "table": name,
                                        "worker": worker,
                                        "trainers": trainers},
                                    timeout=self.BARRIER_TIMEOUT))
            for i in range(len(self.endpoints))])
        midx = np.concatenate([p["idx"] for p in parts])
        mval = np.concatenate([p["val"] for p in parts])
        order = np.argsort(midx, kind="stable")
        return midx[order], mval[order]

    def close(self):
        if self._inval_stop is not None:
            self._inval_stop.set()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        with self._ha_lock:
            clients = list(self._cl_cache.values())
            self._cl_cache.clear()
        for c in clients:
            c.close()


class ParameterServerRuntime:
    """fleet runtime: the server role owns a PSServer shard; the worker
    role owns a PSClient over all server endpoints (reference
    runtime/parameter_server_runtime.py lifecycle)."""

    def __init__(self, role_maker):
        self._role_maker = role_maker
        self.server: PSServer | None = None
        self.client: PSClient | None = None
        self._thread: threading.Thread | None = None
        self._local_tables: dict[str, LargeScaleKV] = {}

    # -- server lifecycle ----------------------------------------------
    def init_server(self, *args, **kwargs):
        """Bind this role's shard; with a model dir (first argument or
        ``dirname=``) load the ``<table>.<host>_<port>.kv`` files a
        ``save`` on the same endpoint wrote."""
        eps = self._role_maker.get_pserver_endpoints()
        me = eps[self._role_maker.server_index()]
        if "|" in me:
            # HA group entry: bind the member matching this process's
            # identity; primary/standby role comes from
            # PADDLE_PS_HA_PRIMARY (the launcher sets both)
            members = me.split("|")
            mine = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
            me = mine if mine in members else members[0]
        self.server = PSServer(me)
        model_dir = args[0] if args else kwargs.get("dirname")
        if model_dir:
            import glob
            tag = self.server.endpoint.replace(":", "_")
            for path in glob.glob(f"{model_dir}/*.{tag}.kv"):
                name = os.path.basename(path).split(".")[0]
                t = LargeScaleKV(1)
                t.load(path)
                self.server.tables[name] = t

    def run_server(self, block: bool = False):
        if self.server is None:
            self.init_server()
        if block:
            self.server.serve_forever()
        else:
            self._thread = self.server.serve_in_thread()
        return self.server

    def stop_server(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()

    # -- worker lifecycle ----------------------------------------------
    def init_worker(self):
        self.client = PSClient(self._role_maker.get_pserver_endpoints())
        return self.client

    def stop_worker(self):
        if self.client is not None:
            self.client.close()

    def get_table(self, name: str, dim: int) -> LargeScaleKV:
        """In-process access (single-process/local mode) — no socket."""
        if self.server is not None:
            return self.server.table(name, dim)
        if name not in self._local_tables:
            self._local_tables[name] = LargeScaleKV(dim)
        return self._local_tables[name]
