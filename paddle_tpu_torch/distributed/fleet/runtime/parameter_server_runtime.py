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

Not in this module yet (each raises NotImplementedError naming its
ROADMAP.md A item): the row-level WAL, hot standbys / epoch fencing and
the tiered store (item 16(b)); continuous publication (item 17); the
hosted telemetry collector (item 18).
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import socketserver
import tempfile
import threading
import time
import weakref

import numpy as np

from ....observability import (debug as _debug, flight as _flight,
                               registry as _obs, watchdog as _watchdog)
from .fault_injection import injector
from .rpc import RpcClient, RpcServerState, TransportStats, _hard_close, \
    serve_connection

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


def _later(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: it comes with ROADMAP.md A, item "
        f"{item}")


def _set(*values) -> bool:
    """Whether any argument or knob turns its feature on."""
    return any(v not in (None, False, 0, "", "0") for v in values)


def _knobs(prefix: str) -> list[str]:
    return [v for k, v in os.environ.items() if k.startswith(prefix)]


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

    The shard is always an unfenced primary. `wal`, `wal_bg_replay`,
    `primary` / `ha_epoch` and `tier_*` (and their PADDLE_PS_* knobs)
    raise naming item 16(b), `publish_dir` / PADDLE_TPU_PUBLISH_DIR
    item 17, PADDLE_TPU_TELEMETRY_HOST=1 item 18."""

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
                               "dgc_push", "dgc_pull", "subscribe_inval"})
    # the high-availability plane's verbs (item 16(b))
    _HA_OPS = frozenset({"repl_watch", "repl_ack", "ha_status",
                         "ha_promote", "ha_handoff"})

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
        if _set(wal, wal_bg_replay, *_knobs("PADDLE_PS_WAL")):
            _later("the row-level WAL (wal=, wal_bg_replay=, "
                   "PADDLE_PS_WAL*)", "16(b)")
        if _set(primary, ha_epoch, *_knobs("PADDLE_PS_HA_")):
            _later("hot standbys and epoch fencing (primary=, ha_epoch=, "
                   "PADDLE_PS_HA_*)", "16(b)")
        if _set(tier_warm_bytes, tier_store_dir, tier_tables,
                *_knobs("PADDLE_PS_TIER_")):
            _later("the tiered embedding store (tier_*=, "
                   "PADDLE_PS_TIER_*)", "16(b)")
        if _set(publish_dir, env("PADDLE_TPU_PUBLISH_DIR")):
            _later("continuous publication (publish_dir=, "
                   "PADDLE_TPU_PUBLISH_DIR)", "17")
        if env("PADDLE_TPU_TELEMETRY_HOST", "") == "1":
            _later("the hosted telemetry collector "
                   "(PADDLE_TPU_TELEMETRY_HOST=1)", "18")
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
        self.snapshots_taken = 0
        self.full_snapshots = 0
        self.delta_snapshots = 0
        self._rpc = RpcServerState(read_ops=self.READ_OPS,
                                   secret=secret,
                                   after_commit=self._after_commit,
                                   commit_scope=self._commit_scope,
                                   after_retry=self._after_retry)
        # every live handler socket, so server_close/kill can sever
        # them (inval streams included — peers must see EOF now, not
        # after a full recv timeout)
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
        self._snap_stop = threading.Event()
        if self.snapshot_dir and self.snapshot_interval > 0:
            threading.Thread(target=self._snapshot_loop,
                             daemon=True).start()

    def serve_in_thread(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th

    def server_close(self):
        self._snap_stop.set()
        super().server_close()
        # sever every live handler socket: inval streams must see EOF
        # NOW, not after a full recv timeout
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            _hard_close(s)

    def kill(self):
        """Stop serving AND sever every open connection — the
        in-process stand-in for shard death (chaos drills)."""
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
        return None

    def _after_commit(self, op: str):
        if op not in self._SNAPSHOT_OPS:
            return
        with self._snap_lock:
            self._mutations += 1
            due = bool(self.snapshot_dir and self.snapshot_every
                       and self._mutations % self.snapshot_every == 0)
        if due:
            self.snapshot()

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
            pending = self._snap_pending
        if pending:
            self.snapshot()

    def _snapshot_loop(self):
        while not self._snap_stop.wait(self.snapshot_interval):
            self.snapshot()

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
        crash in that window into real data loss."""
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
                # deltas (or periodic full bases) forever
                return
            self._snap_seq += 1
            seq = self._snap_seq
            try:
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
        try:
            self._write_snapshot_files(path, arrays, seq, do_full)
        except BaseException:
            # the dirty marks were consumed by this export; a failed
            # export/write must put them back (and flag the owed
            # snapshot for the retry hook) or every later delta would
            # silently omit these tables until the next full base
            with self._snap_lock:
                self._dirty |= dirty
                self._snap_pending = True
            raise
        with self._snap_lock:
            self._snap_pending = False

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
            else:
                self._write_snapshot(self._delta_path(seq), arrays)
                self._deltas_since_base += 1
                self.delta_snapshots += 1
            self.snapshots_taken += 1
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
        """Import one exported state blob (an open npz file) into
        tables + dedup + mutation count."""
        meta = json.loads(bytes(blob["meta"]).decode("utf-8"))
        tables: dict[str, LargeScaleKV] = {}
        for name, tmeta in meta["tables"].items():
            t = LargeScaleKV(int(tmeta["dim"]),
                             init_std=float(tmeta["init_std"]),
                             seed=int(tmeta["seed"]))
            st = {"dim": tmeta["dim"],
                  "init_std": tmeta["init_std"],
                  "seed": tmeta["seed"],
                  "keys": blob[f"k:{name}"],
                  "rows": blob[f"r:{name}"]}
            if "rng" in tmeta:
                st["rng"] = dict(tmeta["rng"], key=blob[f"s:{name}"])
            t.import_state(st)
            tables[name] = t
        lens = blob["dedup_lens"].tolist()
        raw = blob["dedup_blob"].tobytes()
        blobs, off = [], 0
        for n in lens:
            blobs.append(raw[off:off + n])
            off += n
        with self._tables_lock:
            if replace:
                self.tables = tables
            else:
                self.tables.update(tables)
        self._rpc.dedup.import_(blob["dedup_ids"], blobs)
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

    def table(self, name: str, dim: int,
              init_std: float = 0.01) -> LargeScaleKV:
        with self._tables_lock:
            if name not in self.tables:
                self.tables[name] = LargeScaleKV(dim, init_std)
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

    def _dispatch_inner(self, req: dict):
        op = req["op"]
        # a shard epoch on the request skeleton comes from an HA client;
        # epoch 0 (or none) is the plain client this shard serves
        if int(req.pop("_epoch", 0) or 0) or op in self._HA_OPS:
            _later(f"the PS high-availability plane (verb {op!r}, shard "
                   f"epochs)", "16(b)")
        if op.startswith("pub_"):
            _later(f"the publish registry verbs ({op!r})", "17")
        if op.startswith("tel_") \
                or op in ("tsdb_query", "alerts", "usage_report"):
            _later(f"the hosted telemetry collector ({op!r})", "18")
        if op == "pull":
            t = self.table(req["table"], req["dim"],
                           req.get("init_std", 0.01))
            n0 = t.size()
            out = t.pull(req["keys"])
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


class PSClient:
    """Worker-side stub: key-hash routing across server shards (reference
    ps_dispatcher hash dispatch + Communicator send path), one
    fault-tolerant RpcClient channel per shard (retry with stable
    request ids, per-request deadlines, backoff — reference brpc
    channel timeout_ms/max_retry). A ``|``-joined HA group as a shard's
    endpoint raises naming item 16(b)."""

    # sync-mode barrier (and DGC round) calls legitimately block
    # server-side for up to 300s waiting on straggler trainers — their
    # per-attempt timeout must outlast that
    BARRIER_TIMEOUT = 340.0

    def __init__(self, endpoints: list[str], secret: str | None = None,
                 timeout: float | None = None,
                 deadline: float | None = None,
                 max_retries: int | None = None,
                 backoff: float | None = None):
        self.endpoints = [str(ep) for ep in endpoints]
        for ep in self.endpoints:
            if "|" in ep:
                _later(f"PS high-availability groups (shard {ep!r})",
                       "16(b)")
        # wire + fault accounting shared across shard channels
        # (bench/diagnostics read .bytes_out/.bytes_in; robustness
        # tests read .stats)
        self.stats = TransportStats()
        self._clients = [RpcClient(ep, stats=self.stats, secret=secret,
                                   timeout=timeout, deadline=deadline,
                                   max_retries=max_retries,
                                   backoff=backoff)
                         for ep in self.endpoints]
        self._pool = None  # lazy persistent fan-out pool
        self._inval_stop: threading.Event | None = None
        self._inval_threads: list[threading.Thread] = []

    @property
    def bytes_out(self) -> int:
        return self.stats.bytes_out

    @property
    def bytes_in(self) -> int:
        return self.stats.bytes_in

    def _call(self, i: int, req: dict, **kw):
        return self._clients[i].call(req, **kw)

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
        for (i, m), r in zip(masks, res):
            out[m] = r
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
        for c in self._clients:
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
            _later(f"PS high-availability groups (shard {me!r})", "16(b)")
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
