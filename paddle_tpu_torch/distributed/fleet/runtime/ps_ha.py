"""Parameter-server high availability: live WAL replication, epoch
fencing, and shard promotion (counterpart of
``paddle_tpu/distributed/fleet/runtime/ps_ha.py``: the same records,
metric names and ``PADDLE_PS_HA_*`` knobs, so a standby of either
package replicates from a primary of the other).

Roles: every PSServer is a *primary* unless constructed with a primary
endpoint (``PADDLE_PS_HA_PRIMARY`` / ``primary=``), which makes it a
hot *standby*. A primary wraps its row-level WAL journal in
:class:`ReplicatedJournal`, so every committed record (touched rows +
request id + reply blob) is also published — in journal append order —
to the :class:`ReplicationHub`, whose ``repl_watch`` subscribers
(standbys) receive it over the multiplexed wire as server-push frames.
The standby applies each record through the same ensure+assign path
WAL replay uses, commits the request id into its own dedup cache, and
appends to its OWN journal; its tables, RNG streams, and exactly-once
state track the primary row-for-row.

Failover is epoch-fenced: promotion bumps the shard epoch, clients
carry the epoch they last saw (``_epoch`` in the request skeleton),
and a zombie ex-primary that sees a NEWER epoch fences itself and
rejects writes with ``stale_epoch`` — a late write can never fork the
shard. Planned handoff (``ha_handoff``) runs drain -> catch-up ->
epoch flip under the primary's apply lock, so in-flight pushes finish
first and queued ones redirect to the new primary with the SAME
request ids (zero failed pushes, dedup preserved).

Ack modes: replication is async by default. ``PADDLE_PS_HA_SEMISYNC=K``
holds each push's reply until K standbys acked the journaled record
(``wait_semisync``, called from the RPC layer's before_reply hook —
outside the commit scope, so waiting never serializes other pushes).
When standbys die or lag past ``PADDLE_PS_HA_SEMISYNC_TIMEOUT``, the
ack degrades to async — counted and flight-evented — instead of
stalling trainers.
"""
from __future__ import annotations

import queue
import threading
import time
import zlib

import numpy as np

from ....observability import flight as _flight, registry as _obs
from ....checkpoint.wal import RowJournal
from .fault_injection import injector

__all__ = ["ReplicationHub", "ReplicatedJournal", "StandbyReplicator",
           "promote_best", "record_crc", "set_role_gauges",
           "note_promotion", "note_handoff", "note_fenced_write"]

_ROLE = _obs.gauge(
    "paddle_tpu_ps_ha_role",
    "PS shard role: 1 primary, 0 standby", ["endpoint"])
_EPOCH = _obs.gauge(
    "paddle_tpu_ps_ha_epoch",
    "fencing epoch of this PS shard", ["endpoint"])
_STANDBYS = _obs.gauge(
    "paddle_tpu_ps_ha_standbys_connected",
    "replication subscribers currently attached to this primary",
    ["endpoint"])
_LAG_ROWS = _obs.gauge(
    "paddle_tpu_ps_ha_replication_lag_rows",
    "journal records shipped but not yet acked by this standby",
    ["endpoint", "peer"])
_LAG_BYTES = _obs.gauge(
    "paddle_tpu_ps_ha_replication_lag_bytes",
    "journal bytes shipped but not yet acked by this standby",
    ["endpoint", "peer"])
_LAG_SECONDS = _obs.gauge(
    "paddle_tpu_ps_ha_replication_lag_seconds",
    "age of the newest record this standby has acked",
    ["endpoint", "peer"])
_SHIPPED = _obs.counter(
    "paddle_tpu_ps_ha_records_shipped_total",
    "replication records published to standby subscribers",
    ["endpoint"])
_SEMISYNC = _obs.counter(
    "paddle_tpu_ps_ha_semisync_total",
    "semi-sync ack waits by outcome (acked|degraded)", ["outcome"])
_FENCED = _obs.counter(
    "paddle_tpu_ps_ha_fenced_writes_total",
    "mutating ops rejected by epoch fencing (stale_epoch)")
_PROMOTIONS = _obs.counter(
    "paddle_tpu_ps_ha_promotions_total",
    "standby -> primary promotions on this process")
_HANDOFFS = _obs.counter(
    "paddle_tpu_ps_ha_handoffs_total",
    "planned primary handoffs completed by this process")
_RESYNCS = _obs.counter(
    "paddle_tpu_ps_ha_resyncs_total",
    "standby full resyncs (gap, CRC mismatch, or reconnect)")


def set_role_gauges(endpoint: str, role: str, epoch: int):
    """Keep the role/epoch gauges current across promotion/demotion
    (single registration site for every paddle_tpu_ps_ha_* metric is
    this module)."""
    _ROLE.labels(endpoint=endpoint).set(1 if role == "primary" else 0)
    _EPOCH.labels(endpoint=endpoint).set(int(epoch))


def note_promotion(endpoint: str, epoch: int, reason: str = ""):
    _PROMOTIONS.inc()
    _flight.record("ps", "ha_promote", endpoint=endpoint,
                   epoch=int(epoch), reason=reason)


def note_handoff(endpoint: str, target: str, epoch: int):
    _HANDOFFS.inc()
    _flight.record("ps", "ha_handoff", endpoint=endpoint,
                   target=target, epoch=int(epoch))


def note_fenced_write(endpoint: str, op: str, req_epoch: int,
                      epoch: int):
    _FENCED.inc()
    _flight.record("ps", "ha_fenced_write", endpoint=endpoint, op=op,
                   req_epoch=int(req_epoch), epoch=int(epoch))


def record_crc(values) -> int:
    """CRC32 over a rows-record's value bytes: the standby verifies it
    per record, so a corrupt replication frame is detected and answered
    with a resync instead of silently forking the shard."""
    return zlib.crc32(np.ascontiguousarray(
        np.asarray(values, np.float32)).tobytes()) & 0xFFFFFFFF


class _ReplSub:
    """One standby's replication feed: a bounded record queue plus ack
    bookkeeping. Overflow marks the subscriber broken — it tears down
    and resyncs from a fresh bootstrap rather than silently skipping
    records (a gap on this stream is shard divergence)."""

    def __init__(self, sid: int, name: str, maxsize: int):
        self.sid = sid
        self.name = name
        self.q: queue.Queue = queue.Queue(maxsize)
        self.broken = False
        self.acked_seq = 0
        self.acked_bytes = 0
        self.acked_t = 0.0


class ReplicationHub:
    """Primary-side fan-out of committed WAL records to standbys.

    ``order_lock`` is held around journal-append + publish (see
    ReplicatedJournal), so the publish sequence numbers records in
    exactly journal append order — the order standby replay must
    reproduce. Subscription and the bootstrap state export happen under
    the server's apply lock, so a subscriber can never miss a record
    committed after its bootstrap (duplicates across the boundary are
    possible for appends outside the apply lock — sync-barrier rows —
    and are benign: apply is idempotent and the standby skips
    already-applied sequence numbers).
    """

    def __init__(self, endpoint: str, semisync: int | None = None,
                 semisync_timeout: float | None = None,
                 queue_max: int | None = None):
        import os
        env = os.environ.get
        self.endpoint = endpoint
        self.semisync = semisync if semisync is not None else int(
            env("PADDLE_PS_HA_SEMISYNC", "0") or 0)
        self.semisync_timeout = semisync_timeout \
            if semisync_timeout is not None else float(
                env("PADDLE_PS_HA_SEMISYNC_TIMEOUT", "1.0") or 1.0)
        self.queue_max = queue_max if queue_max is not None else int(
            env("PADDLE_PS_HA_QUEUE", "4096") or 0)
        self.order_lock = threading.Lock()
        self._cond = threading.Condition()
        self._subs: dict[int, _ReplSub] = {}
        self._next_sid = 0
        self.seq = 0            # newest published record (monotone)
        self.bytes = 0          # cumulative journal bytes published
        self.last_t = 0.0       # stamp of the newest published record
        self.degraded = 0       # semi-sync waits that fell back to async
        # req_id -> (seq, bytes) of its journal record, consumed by
        # wait_semisync; bounded so a crashed waiter cannot leak it
        self._req_seq: dict[int, tuple[int, int]] = {}

    # -- subscriber lifecycle -------------------------------------------
    def subscribe(self, name: str) -> _ReplSub:
        with self._cond:
            sid = self._next_sid
            self._next_sid += 1
            sub = _ReplSub(sid, name, self.queue_max)
            # a fresh subscriber is caught up to the bootstrap instant
            sub.acked_seq = self.seq
            sub.acked_bytes = self.bytes
            sub.acked_t = self.last_t
            self._subs[sid] = sub
            self._set_gauges_locked()
        return sub

    def unsubscribe(self, sub: _ReplSub):
        with self._cond:
            self._subs.pop(sub.sid, None)
            self._set_gauges_locked()
            self._cond.notify_all()
        for m in (_LAG_ROWS, _LAG_BYTES, _LAG_SECONDS):
            m.remove_matching(endpoint=self.endpoint, peer=sub.name)

    def find(self, name: str) -> _ReplSub | None:
        with self._cond:
            for sub in self._subs.values():
                if sub.name == name and not sub.broken:
                    return sub
        return None

    def status(self) -> list[dict]:
        with self._cond:
            return [{"peer": s.name, "acked_seq": s.acked_seq,
                     "lag_rows": self.seq - s.acked_seq,
                     "broken": s.broken}
                    for s in self._subs.values()]

    def _set_gauges_locked(self):
        _STANDBYS.labels(endpoint=self.endpoint).set(
            sum(1 for s in self._subs.values() if not s.broken))

    def _set_lag_locked(self, sub: _ReplSub):
        _LAG_ROWS.labels(endpoint=self.endpoint, peer=sub.name).set(
            max(0, self.seq - sub.acked_seq))
        _LAG_BYTES.labels(endpoint=self.endpoint, peer=sub.name).set(
            max(0, self.bytes - sub.acked_bytes))
        lag_s = 0.0
        if self.seq > sub.acked_seq and sub.acked_t:
            lag_s = max(0.0, time.time() - sub.acked_t)
        _LAG_SECONDS.labels(endpoint=self.endpoint,
                            peer=sub.name).set(lag_s)

    # -- publish (under order_lock, from ReplicatedJournal) -------------
    def publish(self, rec: dict, req_id: int = 0, nbytes: int = 0):
        with self._cond:
            self.seq += 1
            self.bytes += int(nbytes)
            self.last_t = time.time()
            rec = dict(rec, seq=self.seq, t=self.last_t)
            if self.semisync > 0 and req_id:
                self._req_seq[req_id] = (self.seq, self.bytes)
                while len(self._req_seq) > 8192:
                    self._req_seq.pop(next(iter(self._req_seq)))
            subs = list(self._subs.values())
            for sub in subs:
                if sub.broken:
                    continue
                try:
                    sub.q.put_nowait(rec)
                except queue.Full:
                    # slower than the push rate for a full queue's
                    # worth: kill this feed, the standby resyncs
                    sub.broken = True
            self._set_gauges_locked()
            for sub in subs:
                self._set_lag_locked(sub)
        if subs:
            _SHIPPED.labels(endpoint=self.endpoint).inc(len(
                [s for s in subs if not s.broken]))
        return rec["seq"]

    # -- acks (repl_ack verb) -------------------------------------------
    def ack(self, sid: int, seq: int, nbytes: int = 0, t: float = 0.0):
        with self._cond:
            sub = self._subs.get(int(sid))
            if sub is None:
                return False
            sub.acked_seq = max(sub.acked_seq, int(seq))
            sub.acked_bytes = max(sub.acked_bytes, int(nbytes))
            if t:
                sub.acked_t = float(t)
            self._set_lag_locked(sub)
            self._cond.notify_all()
        return True

    def wait_semisync(self, req_id: int):
        """Hold one push's reply until K live standbys acked its
        record. Degrades (counted + flight event) instead of blocking
        past the timeout or when fewer than K standbys are alive."""
        k = self.semisync
        if k <= 0:
            return
        degraded_seq = None
        with self._cond:
            entry = self._req_seq.pop(req_id, None)
            if entry is None:
                return
            seq, _b = entry
            deadline = time.monotonic() + self.semisync_timeout
            while True:
                live = [s for s in self._subs.values() if not s.broken]
                if sum(1 for s in live if s.acked_seq >= seq) >= k:
                    _SEMISYNC.labels(outcome="acked").inc()
                    return
                left = deadline - time.monotonic()
                if len(live) < k or left <= 0:
                    break
                self._cond.wait(timeout=min(left, 0.05))
            self.degraded += 1
            degraded_seq = seq
        _SEMISYNC.labels(outcome="degraded").inc()
        _flight.record("ps", "ha_semisync_degraded",
                       endpoint=self.endpoint, seq=degraded_seq,
                       want=k)

    def wait_caught_up(self, sub: _ReplSub, seq: int,
                       timeout: float) -> bool:
        """Handoff catch-up: block until `sub` acked through `seq`."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if sub.acked_seq >= seq:
                    return True
                if sub.broken or sub.sid not in self._subs:
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=min(left, 0.25))


class ReplicatedJournal(RowJournal):
    """RowJournal that publishes every append to a ReplicationHub.

    ``order_lock`` spans append + publish: two concurrent appends
    cannot ship in an order different from their on-disk order, which
    is the order standby replay reproduces."""

    def __init__(self, path: str, hub: ReplicationHub, **kw):
        super().__init__(path, **kw)
        self.hub = hub

    @staticmethod
    def _extra_arr(extra: bytes) -> np.ndarray:
        return np.frombuffer(extra, np.uint8) if extra \
            else np.empty(0, np.uint8)

    def append_rows(self, table, idx, values, *, dim=None,
                    init_std: float = 0.01, seed: int = 0,
                    req_id: int = 0, extra: bytes = b"") -> int:
        idx = np.ascontiguousarray(np.asarray(idx, np.int64).ravel())
        values = np.ascontiguousarray(
            np.asarray(values, np.float32)).reshape(len(idx), -1)
        with self.hub.order_lock:
            n = super().append_rows(table, idx, values, dim=dim,
                                    init_std=init_std, seed=seed,
                                    req_id=req_id, extra=extra)
            self.hub.publish(
                {"kind": "rows", "table": str(table),
                 "dim": int(dim if dim is not None
                            else values.shape[1]),
                 "init_std": float(init_std), "seed": int(seed),
                 "idx": idx, "values": values, "req_id": int(req_id),
                 "extra": self._extra_arr(extra),
                 "crc": record_crc(values)},
                req_id=int(req_id), nbytes=n)
        return n

    def append_mark(self, req_id: int, extra: bytes = b"") -> int:
        with self.hub.order_lock:
            n = super().append_mark(req_id, extra)
            self.hub.publish(
                {"kind": "mark", "req_id": int(req_id),
                 "extra": self._extra_arr(extra)},
                req_id=int(req_id), nbytes=n)
        return n

    def publish_rotate(self, wal_seq: int):
        """Rotation/compaction marker: tells standbys the primary
        folded its journal into a fresh base, so they compact their own
        journal too (re-anchoring their local replay chain)."""
        with self.hub.order_lock:
            self.hub.publish({"kind": "rotate",
                              "wal_seq": int(wal_seq)})


class StandbyReplicator:
    """Standby-side replication client: subscribes to the primary's
    ``repl_watch`` stream, imports the bootstrap state, then applies
    each record in sequence through the server's WAL-replay path. A
    gap, CRC mismatch, or transport error tears the stream down and
    resyncs from a fresh bootstrap (counted). A coalescing ack thread
    reports the applied high-water mark back to the primary (semi-sync
    acks + lag gauges)."""

    def __init__(self, server, primary: str):
        self.server = server
        self.primary = primary
        self.stop = threading.Event()
        self.applied_seq = 0
        self.records_applied = 0
        self.resyncs = 0
        self.synced = threading.Event()  # bootstrap imported at least once
        self.last_error: str | None = None
        self._ack_cond = threading.Condition()
        self._ack_t = 0.0
        self._client = None  # live RpcClient, closed() kills it
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"ps-ha-repl-{server.endpoint}")

    def start(self) -> "StandbyReplicator":
        self._thread.start()
        return self

    def close(self):
        self.stop.set()
        cl = self._client
        if cl is not None:
            # sever the live stream so promotion/shutdown never waits
            # out a recv timeout on a quiet primary
            try:
                cl.close()
            except Exception:
                pass
        with self._ack_cond:
            self._ack_cond.notify_all()

    # -- main loop -------------------------------------------------------
    def _run(self):
        from .rpc import RpcClient
        while not self.stop.is_set() \
                and self.server.ha_role == "standby":
            cl = RpcClient(self.primary, timeout=15.0, deadline=20.0,
                           max_retries=1)
            self._client = cl
            ack_stop = threading.Event()
            gen = None
            try:
                gen = cl.call_stream(
                    {"op": "repl_watch", "name": self.server.endpoint},
                    timeout=30.0, stream_timeout=12.0)
                first = next(gen)
                if not isinstance(first, dict) \
                        or "bootstrap" not in first:
                    raise RuntimeError(
                        f"bad repl_watch bootstrap: {type(first)}")
                sid = int(first["sub"])
                self.server._ha_import_bootstrap(
                    first["bootstrap"], int(first["seq"]),
                    int(first["epoch"]))
                self.applied_seq = int(first["seq"])
                self.synced.set()
                ack_th = threading.Thread(
                    target=self._ack_loop, args=(cl, sid, ack_stop),
                    daemon=True,
                    name=f"ps-ha-ack-{self.server.endpoint}")
                ack_th.start()
                self._consume(gen)
            except Exception as e:
                if self.stop.is_set() \
                        or self.server.ha_role != "standby":
                    return
                self.last_error = f"{type(e).__name__}: {e}"
                self.resyncs += 1
                _RESYNCS.inc()
                _flight.record("ps", "ha_resync",
                               endpoint=self.server.endpoint,
                               primary=self.primary,
                               error=self.last_error)
            finally:
                ack_stop.set()
                with self._ack_cond:
                    self._ack_cond.notify_all()
                if gen is not None:
                    try:
                        gen.close()
                    except Exception:
                        pass
                self._client = None
                cl.close()
            self.stop.wait(0.2)

    def _consume(self, gen):
        inj = injector()
        for rec in gen:
            if self.stop.is_set() \
                    or self.server.ha_role != "standby":
                return
            if not isinstance(rec, dict):
                continue
            kind = rec.get("kind")
            if kind == "keepalive":
                continue
            seq = int(rec.get("seq", 0))
            if seq <= self.applied_seq:
                continue  # duplicate across the bootstrap boundary
            if seq != self.applied_seq + 1:
                raise RuntimeError(
                    f"replication gap {self.applied_seq} -> {seq}")
            if kind == "rows" and "crc" in rec \
                    and record_crc(rec["values"]) != int(rec["crc"]):
                raise RuntimeError(
                    f"replication record {seq} failed CRC")
            if kind == "rotate":
                self.server._ha_note_rotate()
            else:
                self.server._ha_apply_record(rec)
            self.applied_seq = seq
            self.records_applied += 1
            if inj.active:
                inj.maybe_kill_at_record(self.records_applied)
            with self._ack_cond:
                self._ack_t = float(rec.get("t", 0.0))
                self._ack_cond.notify_all()
        # generator returned a final reply: the primary ended the
        # stream (demotion/shutdown) — treat as disconnect
        raise ConnectionError("replication stream ended")

    def _ack_loop(self, cl, sid: int, ack_stop: threading.Event):
        sent = -1
        while not ack_stop.is_set():
            with self._ack_cond:
                self._ack_cond.wait_for(
                    lambda: ack_stop.is_set()
                    or self.applied_seq != sent, timeout=1.0)
                seq, t = self.applied_seq, self._ack_t
            if ack_stop.is_set():
                return
            if seq == sent:
                continue
            try:
                cl.call({"op": "repl_ack", "sub": sid, "seq": seq,
                         "bytes": self.server._ha_replicated_bytes,
                         "t": t},
                        timeout=5.0, deadline=5.0, max_retries=0)
                sent = seq
            except Exception:
                if ack_stop.wait(0.2):
                    return


def promote_best(candidates: list[str], epoch: int,
                 timeout: float = 10.0) -> str | None:
    """Failover: probe `candidates` (standby endpoints), pick the
    most-caught-up live one, and promote it with `epoch`. Returns the
    promoted endpoint, or None when no candidate answered. If a
    candidate already claims primary at `epoch` or newer (a racing
    promoter won), it is returned as-is."""
    from .rpc import RpcClient
    best_ep, best_seq = None, -1
    for ep in candidates:
        cl = RpcClient(ep, timeout=2.0, deadline=min(timeout, 4.0),
                       max_retries=0)
        try:
            st = cl.call({"op": "ha_status"}, timeout=2.0)
        except Exception:
            continue
        finally:
            cl.close()
        if not isinstance(st, dict):
            continue
        if st.get("role") == "primary" \
                and int(st.get("epoch", 0)) >= int(epoch):
            return ep
        seq = int(st.get("applied_seq", 0))
        if seq > best_seq:
            best_ep, best_seq = ep, seq
    if best_ep is None:
        return None
    cl = RpcClient(best_ep, timeout=5.0, deadline=timeout,
                   max_retries=1)
    try:
        cl.call({"op": "ha_promote", "epoch": int(epoch)},
                timeout=5.0)
    except Exception:
        return None
    finally:
        cl.close()
    return best_ep
