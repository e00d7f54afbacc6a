"""Durable model-version registry with a streamed watch API.

The registry is the publication pipeline's COMMIT LOG: the exporter
writes a content-addressed version manifest through the checkpoint
store (manifest rename = the version's data commit), then records it
here — latest/pinned/rollback pointers plus per-version metadata
(training step, source run, parity digest). The registry file itself
commits the same way a checkpoint manifest does (canonical JSON, CRC,
tmp + fsync + os.replace), so a publisher killed at ANY byte leaves
the previous version authoritative: a manifest without a registry
record is invisible, a registry record always points at a committed
manifest.

Pointers:
  latest   — what subscribers should serve (rollback REWINDS it)
  pinned   — the operator-blessed fallback a failed fleet rollout
             rolls back to

Watch API: `registry_dispatch` serves the `pub_*` verbs over the
multiplexed RPC wire (``distributed/fleet/runtime/rpc.py``) — `pub_watch` is a dispatch GENERATOR whose version-announce
frames ride the same F_STREAM machinery as the PS hot-row
invalidations (bounded per-subscriber queue, keepalive frames, cancel
via F_CANCEL -> GeneratorExit). The verbs are hosted by the PSServer
when publishing is wired there, or by the standalone RegistryServer.
Cross-process publishers are picked up by `reload()` (the watch loop
re-reads the file on idle), so the wire and the file agree on one
source of truth. The registry file is the JAX package's bytes (same
format tag, canonical payload and CRC), so either package reloads a
registry the other wrote.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib

from ..observability import flight as _flight, registry as _obs

__all__ = ["RegistryError", "VersionRegistry", "registry_dispatch",
           "RegistryServer", "RegistryClient", "PUB_READ_OPS"]

FORMAT = "paddle-tpu-pubreg-v1"
REGISTRY_NAME = "REGISTRY.json"

_PUBLICATIONS = _obs.counter(
    "paddle_tpu_publish_publications_total",
    "model versions committed to the registry, by manifest kind",
    ["kind"], always=True)
_ROLLBACKS = _obs.counter(
    "paddle_tpu_publish_rollbacks_total",
    "registry rollbacks (latest rewound to an older version)",
    always=True)

# pub_* verbs that never mutate the registry — dedup-exempt on any
# hosting server (a replayed pub_watch must open a fresh stream)
PUB_READ_OPS = frozenset({"pub_latest", "pub_get", "pub_list",
                          "pub_watch"})


class RegistryError(RuntimeError):
    """No committed registry, or the file on disk is unreadable."""


def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


class _WatchSub:
    """One watcher's announce feed: a bounded queue; overflow keeps a
    'behind' flag so a slow watcher resyncs from the latest record
    instead of stalling publications or silently losing the newest."""

    def __init__(self, maxsize: int):
        self.q: queue.Queue = queue.Queue(maxsize)
        self.behind = False
        self.lock = threading.Lock()


class VersionRegistry:
    """File-backed registry under a publish root. Thread-safe; shared
    by the exporter (publish), the rollout coordinator (pin/rollback)
    and any number of watchers (in-process queues + `reload()` for
    records committed by other processes)."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, REGISTRY_NAME)
        self._lock = threading.RLock()
        self._state: dict = {"latest": 0, "pinned": 0, "rollbacks": 0,
                             "versions": {}}
        self._subs: dict[int, _WatchSub] = {}
        self._sub_seq = 0
        self._queue_max = int(os.environ.get(
            "PADDLE_TPU_PUBLISH_WATCH_QUEUE", "256") or 0)
        # commit protocol state: snapshots are numbered under _lock,
        # the file write runs with NO lock held (newest snapshot wins)
        self._io_cond = threading.Condition()
        self._io_gen = 0          # last snapshot taken
        self._io_written = 0      # last snapshot durably on disk
        self._io_busy = False
        self.reload(missing_ok=True)

    # -- durability ----------------------------------------------------
    def _snapshot_locked(self) -> tuple[int, bytes]:
        """Serialize the current state to commit-ready doc bytes and
        stamp it with a monotonically increasing generation. Caller
        holds ``_lock``; the returned doc is written by ``_write_doc``
        AFTER the lock is released — holding a mutex across file I/O
        would stall every reader behind an fsync."""
        payload = self._state
        body = _canonical(payload)
        doc = json.dumps({"format": FORMAT,
                          "crc32": zlib.crc32(body) & 0xFFFFFFFF,
                          "payload": payload}).encode("utf-8")
        self._io_gen += 1
        return self._io_gen, doc

    def _write_doc(self, gen: int, doc: bytes) -> None:
        """Commit one snapshot, lock-free: single-flight with
        newest-generation-wins. A writer that arrives while an older
        snapshot is in flight waits for it; a writer whose snapshot
        was superseded on disk skips entirely — its mutation is
        already contained in the newer doc. The rename is the commit
        point, exactly like a checkpoint manifest."""
        with self._io_cond:
            while self._io_busy and self._io_written < gen:
                self._io_cond.wait(1.0)
            if self._io_written >= gen:
                return            # a newer snapshot already landed
            self._io_busy = True
        try:
            os.makedirs(self.root, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(doc)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        finally:
            with self._io_cond:
                self._io_busy = False
                if gen > self._io_written:
                    self._io_written = gen
                self._io_cond.notify_all()

    @staticmethod
    def _load_file(path: str) -> dict:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8"))
        if doc.get("format") != FORMAT:
            raise RegistryError(f"{path}: not a {FORMAT} registry")
        payload = doc["payload"]
        crc = zlib.crc32(_canonical(payload)) & 0xFFFFFFFF
        if crc != int(doc.get("crc32", -1)):
            raise RegistryError(f"{path}: CRC mismatch")
        return payload

    def reload(self, missing_ok: bool = False) -> bool:
        """Re-read the file (cross-process publications). Returns True
        when `latest` moved; newly-visible records are announced to
        in-process watchers. A torn/corrupt file keeps the in-memory
        state (the previous commit stays authoritative).

        The file is adopted only if it is at least as new as this
        handle's own state: every mutation this handle made had landed
        on disk before the read began, and none was made during it.
        Otherwise the doc read may predate an in-flight write of this
        very registry (writes run lock-free, newest snapshot wins), and
        adopting it would rewind `latest` and hand a published version
        number out again."""
        with self._lock:
            gen0 = self._io_gen
        with self._io_cond:
            settled = self._io_written >= gen0
        if not settled:
            return False
        try:
            payload = self._load_file(self.path)
        except FileNotFoundError:
            if missing_ok:
                return False
            raise RegistryError(f"no registry under {self.root}")
        except (RegistryError, OSError, ValueError, KeyError):
            return False
        with self._lock:
            if self._io_gen != gen0:
                return False      # mutated meanwhile: memory is newer
            moved = int(payload.get("latest", 0)) \
                != int(self._state.get("latest", 0))
            self._state = payload
            rec = self._record_locked(int(payload.get("latest", 0)))
        if moved and rec is not None:
            self._announce(rec)
        return moved

    # -- queries -------------------------------------------------------
    def latest(self) -> int:
        with self._lock:
            return int(self._state["latest"])

    def pinned(self) -> int:
        with self._lock:
            return int(self._state["pinned"])

    def rollbacks(self) -> int:
        with self._lock:
            return int(self._state.get("rollbacks", 0))

    def _record_locked(self, version: int) -> dict | None:
        rec = self._state["versions"].get(str(version))
        if rec is None:
            return None
        return dict(rec, version=int(version),
                    pinned=int(self._state["pinned"]))

    def get(self, version: int) -> dict | None:
        with self._lock:
            return self._record_locked(int(version))

    def record_latest(self) -> dict | None:
        with self._lock:
            return self._record_locked(int(self._state["latest"]))

    def versions(self) -> list[dict]:
        with self._lock:
            return [self._record_locked(int(v))
                    for v in sorted(self._state["versions"],
                                    key=int)]

    def next_version(self) -> int:
        with self._lock:
            known = [int(v) for v in self._state["versions"]]
            return max([int(self._state["latest"])] + known) + 1

    # -- mutations -----------------------------------------------------
    def publish(self, version: int, *, step: int, kind: str,
                digest: str = "", run: str = "",
                extra: dict | None = None) -> dict:
        """Commit one published version: record + move `latest`. The
        caller must have committed the version's manifest FIRST — this
        is the visibility flip, done after the data is durable."""
        with self._lock:
            version = int(version)
            rec = {"step": int(step), "kind": str(kind),
                   "digest": str(digest), "run": str(run),
                   "unix": time.time()}
            if extra:
                rec["extra"] = extra
            self._state["versions"][str(version)] = rec
            self._state["latest"] = version
            gen, doc = self._snapshot_locked()
            out = self._record_locked(version)
        self._write_doc(gen, doc)
        _PUBLICATIONS.labels(kind=str(kind)).inc()
        _flight.record("publish", "publish", root=self.root,
                       version=version, step=int(step), kind=kind)
        self._announce(out)
        return out

    def pin(self, version: int) -> dict:
        with self._lock:
            rec = self._record_locked(int(version))
            if rec is None:
                raise RegistryError(f"cannot pin unknown version "
                                    f"{version}")
            self._state["pinned"] = int(version)
            gen, doc = self._snapshot_locked()
            out = self._record_locked(int(version))
        self._write_doc(gen, doc)
        return out

    def rollback(self, to: int | None = None) -> dict:
        """Rewind `latest` to `to` (default: the pinned version, else
        the newest version older than latest). Announced to watchers
        like a publication — subscribers swap DOWN the same way they
        swap up."""
        with self._lock:
            latest = int(self._state["latest"])
            if to is None:
                to = int(self._state["pinned"]) or 0
            if not to:
                older = [int(v) for v in self._state["versions"]
                         if int(v) < latest]
                to = max(older) if older else 0
            rec = self._record_locked(int(to))
            if rec is None:
                raise RegistryError(
                    f"no rollback target (asked {to}, latest {latest})")
            self._state["latest"] = int(to)
            self._state["rollbacks"] = \
                int(self._state.get("rollbacks", 0)) + 1
            gen, doc = self._snapshot_locked()
            out = self._record_locked(int(to))
        self._write_doc(gen, doc)
        _ROLLBACKS.inc()
        _flight.record("publish", "rollback", root=self.root,
                       to=int(to), was=latest)
        self._announce(out)
        return out

    # -- watch fan-out -------------------------------------------------
    def watch_queue(self) -> tuple[int, _WatchSub]:
        with self._lock:
            self._sub_seq += 1
            sid = self._sub_seq
            sub = _WatchSub(self._queue_max)
            self._subs[sid] = sub
            return sid, sub

    def unwatch(self, sid: int):
        with self._lock:
            self._subs.pop(sid, None)

    def _announce(self, rec: dict):
        with self._lock:
            subs = list(self._subs.values())
        for s in subs:
            try:
                s.q.put_nowait(dict(rec))
            except queue.Full:
                with s.lock:
                    s.behind = True


def registry_dispatch(reg: VersionRegistry, req: dict,
                      keepalive: float = 5.0):
    """The pub_* verb switch, shared by every server that hosts a
    registry (PSServer when publishing is wired, RegistryServer
    standalone). Returns a reply dict — or, for pub_watch, a dispatch
    generator the RPC layer streams as server-push frames."""
    op = req["op"]
    if op == "pub_latest":
        reg.reload(missing_ok=True)
        return {"latest": reg.latest(), "pinned": reg.pinned(),
                "record": reg.record_latest()}
    if op == "pub_get":
        return {"record": reg.get(int(req["version"]))}
    if op == "pub_list":
        return {"versions": reg.versions(), "latest": reg.latest(),
                "pinned": reg.pinned(),
                "rollbacks": reg.rollbacks()}
    if op == "pub_publish":
        rec = reg.publish(int(req["version"]),
                          step=int(req.get("step", 0)),
                          kind=str(req.get("kind", "")),
                          digest=str(req.get("digest", "")),
                          run=str(req.get("run", "")),
                          extra=req.get("extra"))
        return {"record": rec}
    if op == "pub_pin":
        return {"record": reg.pin(int(req["version"]))}
    if op == "pub_rollback":
        to = req.get("to")
        return {"record": reg.rollback(None if to is None
                                       else int(to))}
    if op == "pub_watch":
        return _watch_stream(reg, keepalive)
    raise ValueError(f"unknown publish op {op!r}")


def _watch_stream(reg: VersionRegistry, keepalive: float):
    """pub_watch dispatch generator: subscribe ack (carrying the
    current latest so a late joiner can catch up immediately), then
    one announce frame per publication/rollback. Keepalives every few
    seconds keep the stream's cancel check live while nothing
    publishes — and double as the reload tick that surfaces versions
    committed by OTHER processes into this wire."""
    sid, sub = reg.watch_queue()
    try:
        yield {"subscribed": True, "latest": reg.latest(),
               "record": reg.record_latest()}
        while True:
            with sub.lock:
                behind, sub.behind = sub.behind, False
            if behind:
                # overflow: resync from the authoritative pointer
                # instead of replaying a lost backlog
                rec = reg.record_latest()
                if rec is not None:
                    yield dict(rec, resync=True)
            try:
                ev = sub.q.get(timeout=keepalive)
            except queue.Empty:
                reg.reload(missing_ok=True)  # cross-process publishers
                yield {"keepalive": True, "latest": reg.latest()}
                continue
            yield ev
    finally:
        reg.unwatch(sid)


class RegistryServer:
    """Standalone registry endpoint over the mux wire — for
    deployments where the publisher is not a PSServer (e.g. a dense
    trainer publishing straight from its host loop). Serves exactly
    `registry_dispatch` plus ping."""

    READ_OPS = frozenset(PUB_READ_OPS | {"ping"})

    def __init__(self, root: str, endpoint: str = "127.0.0.1:0",
                 secret: str | None = None,
                 registry: VersionRegistry | None = None):
        import socketserver

        from ..distributed.fleet.runtime.rpc import (RpcServerState,
                                                     serve_connection)
        self.registry = registry or VersionRegistry(root)
        self._rpc = RpcServerState(read_ops=self.READ_OPS,
                                   secret=secret)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                serve_connection(self.request, outer._dispatch,
                                 outer._rpc)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        host, port = endpoint.rsplit(":", 1)
        self._server = Server((host, int(port)), Handler)
        self.endpoint = f"{host}:{self._server.server_address[1]}"
        self._thread: threading.Thread | None = None

    def _dispatch(self, req: dict):
        if req.get("op") == "ping":
            return {"ok": True, "latest": self.registry.latest()}
        return registry_dispatch(self.registry, req)

    def start(self) -> "RegistryServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="publish-registry")
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class RegistryClient:
    """Thin pub_* client over the multiplexed RpcClient — works
    against a RegistryServer or a publish-wired PSServer alike."""

    def __init__(self, endpoint: str, secret: str | None = None,
                 timeout: float | None = None):
        from ..distributed.fleet.runtime.rpc import RpcClient
        self._rpc = RpcClient(endpoint, secret=secret,
                              timeout=timeout if timeout is not None
                              else 30.0)

    def latest(self) -> dict:
        return self._rpc.call({"op": "pub_latest"})

    def get(self, version: int) -> dict | None:
        return self._rpc.call({"op": "pub_get",
                               "version": int(version)}).get("record")

    def list(self) -> dict:
        return self._rpc.call({"op": "pub_list"})

    def publish(self, version: int, *, step: int, kind: str,
                digest: str = "", run: str = "",
                extra: dict | None = None) -> dict:
        return self._rpc.call({"op": "pub_publish",
                               "version": int(version),
                               "step": int(step), "kind": kind,
                               "digest": digest, "run": run,
                               "extra": extra})["record"]

    def pin(self, version: int) -> dict:
        return self._rpc.call({"op": "pub_pin",
                               "version": int(version)})["record"]

    def rollback(self, to: int | None = None) -> dict:
        return self._rpc.call({"op": "pub_rollback",
                               "to": to})["record"]

    def watch(self, on_record, stop: threading.Event | None = None,
              keepalive_timeout: float = 30.0) -> threading.Event:
        """Stream version announces: ``on_record(rec)`` fires per
        publication/rollback from a background thread (rec carries
        version/step/kind/digest/pinned). Returns a stop Event; a
        broken stream re-subscribes with backoff — the subscribe ack's
        current-latest record is re-delivered so a watcher that missed
        announces while disconnected catches up."""
        stop = stop or threading.Event()

        def loop():
            while not stop.is_set():
                gen = None
                try:
                    gen = self._rpc.call_stream(
                        {"op": "pub_watch"}, timeout=30.0,
                        stream_timeout=keepalive_timeout)
                    for ev in gen:
                        if stop.is_set():
                            return
                        if not isinstance(ev, dict):
                            continue
                        rec = ev.get("record") \
                            if ev.get("subscribed") else ev
                        if isinstance(rec, dict) \
                                and rec.get("version"):
                            on_record(rec)
                except Exception:
                    pass     # registry host down: re-subscribe
                finally:
                    if gen is not None:
                        try:
                            gen.close()
                        except Exception:
                            pass
                stop.wait(0.5)

        threading.Thread(target=loop, daemon=True,
                         name="publish-watch").start()
        return stop

    def close(self):
        self._rpc.close()
