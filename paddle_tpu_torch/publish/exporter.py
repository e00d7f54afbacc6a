"""Publication exporters: train-side state → numbered servable versions.

``Publisher`` is the commit path every producer shares. One published
version is one step in a dedicated ``CheckpointStore`` under the
publish root (version number == manifest step), so consecutive
publications dedup at the chunk level — a training interval that
touched 1% of a table re-references ~99% of its chunks — and the
manifest rename is the data commit. The registry record (latest
pointer + parity digest) lands strictly AFTER the manifest: a
publisher killed anywhere in between leaves a dangling manifest no
subscriber can see, and the previous version stays servable
bit-for-bit.

``PSExporter`` closes the loop from PS training: the server's
``after_commit`` hook feeds ``note_commit`` (counters only — the push
path never does publication IO), and a background thread publishes
when any cadence knob fires (every N applied mutations, every T
seconds, every R rows touched). The table export runs under the
server's apply lock (same consistency contract as snapshots:
``export_state`` copies, so the lock covers the memcpy, not the chunk
IO); the chunk+manifest write happens off-lock.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time

from ..checkpoint.store import CheckpointStore
from ..observability import flight as _flight, registry as _obs
from .registry import VersionRegistry

__all__ = ["Publisher", "PSExporter", "parity_digest"]

_DEDUP_RATIO = _obs.gauge(
    "paddle_tpu_publish_dedup_ratio",
    "chunk dedup of the newest publication: fraction of its chunks "
    "re-referenced from earlier versions (1.0 = nothing rewritten)")
_PUBLISH_SECONDS = _obs.histogram(
    "paddle_tpu_publish_seconds",
    "wall time of one version publication (export + chunks + "
    "manifest + registry commit)", ["kind"])


def parity_digest(payload: dict) -> str:
    """Digest of a committed manifest's content identity: every
    array's name, dtype/shape, and chunk-hash sequence, canonically
    ordered. Two versions with equal digests restore bit-for-bit
    equal state — the registry stores it so a subscriber (or the
    kill-mid-publication drill) can verify what it serves without
    re-reading chunk data."""
    ident = {name: {"dtype": rec["dtype"],
                    "shape": rec["shape"],
                    "chunks": [c["h"] for c in rec["chunks"]]}
             for name, rec in payload["arrays"].items()}
    body = json.dumps(ident, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(body).hexdigest()


class Publisher:
    """Versioned publication front over one publish root: a
    CheckpointStore for the data and a VersionRegistry for the
    pointers. Thread-safe; one instance may serve several producers
    (dense trainer + PS exporter publishing distinct kinds)."""

    def __init__(self, root: str, registry: VersionRegistry | None = None,
                 store: CheckpointStore | None = None,
                 keep: int | None = None, run: str = ""):
        self.root = root
        if keep is None:
            keep = int(os.environ.get("PADDLE_TPU_PUBLISH_KEEP", "4")
                       or 0) or 4
        self.store = store or CheckpointStore(root, keep=keep)
        self.registry = registry or VersionRegistry(root)
        self.run = run
        self._lock = threading.Lock()
        self.published = 0
        self.last_version = 0
        self.last_dedup_ratio = 0.0

    def publish_arrays(self, arrays: dict, *, step: int, kind: str,
                       meta: dict | None = None) -> dict:
        """Publish one version from name→array state. Returns the
        committed registry record (version, step, kind, digest,
        dedup)."""
        t0 = time.perf_counter()
        with self._lock:
            version = self.registry.next_version()
            c = self.store.chunks
            w0, d0 = c.chunks_written, c.dedup_hits
            self.store.save(arrays, step=version,
                            meta=dict(meta or {}, kind=kind,
                                      step=int(step)))
            # the manifest for `version` is now durable — a crash from
            # here on leaves it dangling (invisible) until the registry
            # record below commits, never a half-published version
            written = c.chunks_written - w0
            total = written + (c.dedup_hits - d0)
            ratio = (1.0 - written / total) if total else 1.0
            payload = self.store.latest_manifest(version)
            digest = parity_digest(payload)
            rec = self.registry.publish(
                version, step=step, kind=kind, digest=digest,
                run=self.run, extra={"dedup": round(ratio, 4)})
            self.published += 1
            self.last_version = version
            self.last_dedup_ratio = ratio
        _DEDUP_RATIO.set(ratio)
        dt = time.perf_counter() - t0
        _PUBLISH_SECONDS.labels(kind=kind).observe(dt)
        _flight.record("publish", "export", root=self.root,
                       version=version, step=int(step), kind=kind,
                       dedup=round(ratio, 4), seconds=round(dt, 6))
        return rec

    def publish_model(self, model, *, step: int) -> dict:
        """Publish a GPTDecodeModel's weights in the exact layout
        ``Engine.warm_start`` restores: tree-path-keyed arrays (the JAX
        package's ``keystr`` keys, in its flatten order; a block leaf's
        per-layer tensors are the pieces of its stacked byte stream)
        plus the gpt-decode meta (kind + cfg) ``read_checkpoint``
        validates. Tensors may lie on any device: the store copies them
        to the host chunk by chunk."""
        from ..serving.model import checkpoint_arrays
        return self.publish_arrays(
            checkpoint_arrays(model.params), step=step, kind="gpt-decode",
            meta={"cfg": dataclasses.asdict(model.cfg)})


class PSExporter:
    """Continuous publication off a live PSServer. The server's
    ``_after_commit`` calls ``note_commit`` per applied mutation
    (cheap: counters + event). The exporter thread wakes when a knob's
    threshold is crossed — steps (applied mutations), seconds, or rows
    touched — exports every table under the apply lock, and publishes
    through the shared ``Publisher`` off-lock."""

    def __init__(self, server, publisher: Publisher,
                 every_steps: int | None = None,
                 every_seconds: float | None = None,
                 every_rows: int | None = None):
        env = os.environ.get
        self.server = server
        self.publisher = publisher
        self.every_steps = int(env("PADDLE_TPU_PUBLISH_EVERY_STEPS",
                                   "0") or 0) \
            if every_steps is None else int(every_steps)
        self.every_seconds = float(
            env("PADDLE_TPU_PUBLISH_EVERY_SECONDS", "0") or 0) \
            if every_seconds is None else float(every_seconds)
        self.every_rows = int(env("PADDLE_TPU_PUBLISH_EVERY_ROWS",
                                  "0") or 0) \
            if every_rows is None else int(every_rows)
        self._lock = threading.Lock()
        self._steps = 0           # mutations since last publication
        self._rows = 0            # rows touched since last publication
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_publish_unix = 0.0

    def note_commit(self, op: str, rows: int = 0):
        """Called from the server's after_commit hook — push-path hot,
        so this only counts and (maybe) sets the wake event."""
        with self._lock:
            self._steps += 1
            self._rows += int(rows)
            due = (self.every_steps
                   and self._steps >= self.every_steps) \
                or (self.every_rows and self._rows >= self.every_rows)
        if due:
            self._kick.set()

    def note_rows(self, rows: int):
        """Row accounting for the every_rows knob — called from the
        push apply path with the request's key count (after_commit
        only sees the op name)."""
        with self._lock:
            self._rows += int(rows)
            due = bool(self.every_rows
                       and self._rows >= self.every_rows)
        if due:
            self._kick.set()

    def _due(self) -> bool:
        with self._lock:
            if self._steps == 0:
                return False
            if self.every_steps and self._steps >= self.every_steps:
                return True
            if self.every_rows and self._rows >= self.every_rows:
                return True
        return bool(self.every_seconds
                    and time.time() - self.last_publish_unix
                    >= self.every_seconds)

    def publish_now(self) -> dict | None:
        """One publication cycle (also the thread body's work unit).
        Returns the registry record, or None when the server holds no
        tables yet."""
        srv = self.server
        with self._lock:
            steps, self._steps = self._steps, 0
            self._rows = 0
        # export under the apply lock: same instant for every table,
        # and never interleaved with a push's apply+journal pair
        with srv._apply_lock:
            arrays = {}
            meta_tables = {}
            with srv._tables_lock:
                items = list(srv.tables.items())
            for name, t in items:
                st = t.export_state()
                arrays[f"k:{name}"] = st["keys"]
                arrays[f"r:{name}"] = st["rows"]
                meta_tables[name] = {"dim": st["dim"],
                                     "init_std": st["init_std"],
                                     "seed": st["seed"]}
            with srv._snap_lock:
                mutations = srv._mutations
        if not arrays:
            return None
        rec = self.publisher.publish_arrays(
            arrays, step=mutations, kind="ps-table",
            meta={"endpoint": srv.endpoint, "tables": meta_tables,
                  "interval_steps": steps})
        self.last_publish_unix = time.time()
        return rec

    def _loop(self):
        while not self._stop.is_set():
            wait = 0.05 if not self.every_seconds else \
                min(self.every_seconds / 4, 1.0)
            self._kick.wait(wait)
            self._kick.clear()
            if self._stop.is_set():
                return
            if self._due():
                try:
                    self.publish_now()
                except Exception:
                    # publication must never take the shard down; the
                    # next cadence tick retries (previous version is
                    # still the registry's latest)
                    _flight.record("publish", "export_failed",
                                   root=self.publisher.root,
                                   endpoint=self.server.endpoint)

    def start(self) -> "PSExporter":
        if self._thread is None:
            self.last_publish_unix = time.time()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ps-publisher")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
