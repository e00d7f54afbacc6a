"""CheckpointStore — crash-consistent, incremental, resharding-aware
array checkpoints.

Save path: every array is laid out as its C-contiguous global byte
stream and cut on a FIXED chunk grid (``chunk_bytes`` boundaries from
byte 0). The grid is a function of the global array only — not of the
shard layout it was saved from — so (a) a step that mutates 1% of
the state re-references ~99% of its chunks from the previous manifest
(dedup, never rewritten), and (b) a checkpoint saved under one shard
layout restores under any other (the chunk grid is reassembled for
whatever byte ranges the new layout needs). The manifest rename is the
single commit point (manifest.py); a crash anywhere before it leaves
the previous checkpoint untouched.

Async save: ``save_async`` snapshots HOST COPIES of every array
synchronously (a memcpy, not a disk write) and enqueues them for ONE
persistent background writer thread — the train/decode step never
blocks on chunk IO. The queue holds at most two pending saves: a
cadence the writer keeps up with never blocks at all, and sustained
overload degrades to backpressure (blocking in save_async) instead of
unbounded host-copy memory. Errors surface on ``wait()`` or the next
save.

Restore: ``restore()`` reassembles full arrays; ``restore_shard``
reads ONLY the chunks overlapping one shard's byte range (axis-0
sharding maps to a contiguous byte span of the C order), which is how
a resharded restart avoids reading state it doesn't own.

Retention: the newest ``keep`` manifests survive (env
``PADDLE_TPU_CKPT_KEEP``, default 2 — crash recovery always has the
previous step); retention GC deletes older manifests, then chunks no
retained manifest references.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..observability import flight as _flight, registry as _obs
from . import manifest as _manifest
from .chunks import ChunkStore

__all__ = ["CheckpointStore", "ShardedArray", "DEFAULT_CHUNK_BYTES"]

# chunks a save or a restore hashes, writes or reads at once: sha256 and
# file I/O release the GIL, and sha256 runs near 1.1 GB/s on one core.
# Half the host's cores: a save or a restore runs beside serving (a
# publication, a warm start, a replica's respawn), and with every core
# hashing, the decode loops beside it stalled for seconds
_IO_THREADS = max(1, (os.cpu_count() or 2) // 2)

DEFAULT_CHUNK_BYTES = 1 << 20

_SAVE_SECONDS = _obs.histogram(
    "paddle_tpu_ckpt_save_seconds",
    "wall time of one checkpoint save (async = writer-thread time)",
    ["mode"])
_RESTORE_SECONDS = _obs.histogram(
    "paddle_tpu_ckpt_restore_seconds",
    "wall time of one checkpoint restore")
_SAVES = _obs.counter(
    "paddle_tpu_ckpt_saves_total",
    "checkpoint saves committed, by mode", ["mode"])

# async-writer queue gauges, evaluated at exposition time over every
# live store (zero hot-path writes): a rising queue depth / pending
# bytes means the train cadence is outrunning the writer (backpressure
# imminent), and a large in-flight save age is a wedged disk — the
# stall signals the watchdog/postmortem tier reads
_STORES: "weakref.WeakSet[CheckpointStore]" = weakref.WeakSet()


def _sum_stores(fn) -> float:
    total = 0.0
    for s in list(_STORES):
        try:
            total += fn(s)
        except Exception:
            pass
    return total


_WRITER_QUEUE_DEPTH = _obs.gauge(
    "paddle_tpu_ckpt_writer_queue_depth",
    "async saves queued for the background writer (live, all stores)")
_WRITER_QUEUE_DEPTH.set_function(lambda: _sum_stores(
    lambda s: s._queue.qsize() if s._queue is not None else 0))
_WRITER_PENDING_BYTES = _obs.gauge(
    "paddle_tpu_ckpt_writer_pending_bytes",
    "host-copy bytes held by queued + in-flight async saves (live)")
_WRITER_PENDING_BYTES.set_function(
    lambda: _sum_stores(lambda s: s._pending_bytes))
_INFLIGHT_SAVE_SECONDS = _obs.gauge(
    "paddle_tpu_ckpt_inflight_save_seconds",
    "age of the oldest in-flight async save write (live; 0 when idle)")
# snapshot _save_started ONCE per store — the writer thread clears it
# concurrently, and a second read racing that clear would be float-None
_INFLIGHT_SAVE_SECONDS.set_function(lambda: max(
    (time.monotonic() - t
     for t in (s._save_started for s in list(_STORES))
     if t is not None), default=0.0))


class ShardedArray:
    """A logically-global array provided as per-shard host pieces
    (axis-0 concatenation order) — the save-side view of a row-sharded
    parameter. The store chunks the GLOBAL byte stream, so the
    manifest is identical whatever sharding produced it."""

    def __init__(self, pieces, axis: int = 0):
        if axis != 0:
            raise ValueError("ShardedArray: only axis-0 sharding maps "
                             "to contiguous byte spans; transpose "
                             "before saving for other layouts")
        self.pieces = [np.ascontiguousarray(_host_array(p))
                       for p in pieces]
        if not self.pieces:
            raise ValueError("ShardedArray needs at least one piece")
        first = self.pieces[0]
        for p in self.pieces[1:]:
            if p.shape[1:] != first.shape[1:] or p.dtype != first.dtype:
                raise ValueError("ShardedArray pieces disagree on "
                                 "trailing shape/dtype")
        self.dtype = first.dtype
        self.shape = (sum(p.shape[0] for p in self.pieces),) \
            + first.shape[1:]
        self.nbytes = sum(p.nbytes for p in self.pieces)

    def iter_bytes(self, chunk_bytes: int):
        """Yield the global byte stream cut on the fixed chunk grid —
        chunks may span piece boundaries (the grid must not depend on
        the sharding). Aligned spans slice straight out of the piece
        (no staging copy — the save path is memory-bandwidth-bound)."""
        buf = bytearray()
        for p in self.pieces:
            if p.nbytes == 0:
                continue
            mv = memoryview(p).cast("B")
            off = 0
            if buf:  # finish the chunk straddling the piece boundary
                take = min(chunk_bytes - len(buf), len(mv))
                buf += mv[:take]
                off = take
                if len(buf) < chunk_bytes:
                    continue
                yield bytes(buf)
                buf.clear()
            while off + chunk_bytes <= len(mv):
                yield mv[off:off + chunk_bytes].tobytes()
                off += chunk_bytes
            if off < len(mv):
                buf += mv[off:]
        if buf:
            yield bytes(buf)


def _stop_writer(q):
    try:
        q.put_nowait(None)
    except Exception:
        pass


def _host_array(x) -> np.ndarray:
    """Materialise any array-like (numpy, or a ``torch.Tensor`` on any
    device: detached and copied to the host) as a C-contiguous host
    ndarray. NOT ascontiguousarray: that promotes 0-d to 1-d and would
    lose scalar shapes in the manifest. bfloat16 has no numpy dtype the
    chunker can cut (the JAX package's store fails on it too), so a
    bfloat16 tensor raises. torch is read from ``sys.modules``: a
    process that never imported it holds no tensor, and the parameter
    server's cold tier uses this store without importing torch."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise ValueError(
                "cannot checkpoint a bfloat16 tensor: the store's format "
                "has no bfloat16 encoding (the JAX package refuses it "
                "too); cast it to float32 first")
        x = x.detach().cpu().resolve_conj().resolve_neg().numpy()
    arr = np.asarray(x)
    if arr.ndim and not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    return arr


class CheckpointStore:
    def __init__(self, root: str, chunk_bytes: int | None = None,
                 keep: int | None = None):
        self.root = root
        env = os.environ.get
        self.chunk_bytes = int(chunk_bytes if chunk_bytes is not None
                               else env("PADDLE_TPU_CKPT_CHUNK_BYTES",
                                        str(DEFAULT_CHUNK_BYTES)))
        if self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        self.keep = int(keep if keep is not None
                        else env("PADDLE_TPU_CKPT_KEEP", "2"))
        self.chunks = ChunkStore(root)
        self._async_lock = threading.Lock()
        self._async_error: BaseException | None = None
        self._queue: "queue.Queue | None" = None  # lazy writer thread
        self._last_step = 0
        self._pending_bytes = 0          # queued + in-flight host copies
        self._save_started: float | None = None  # writer busy since
        _STORES.add(self)

    # -- save -----------------------------------------------------------
    def _resolve_step(self, step: int | None) -> int:
        """Assign (or fold in an explicit) step number under the lock:
        queued async saves hold steps not yet on disk, and an explicit
        high step must not be shadowed by a later auto-assigned lower
        one (restore() returns the highest committed step)."""
        with self._async_lock:
            if step is None:
                ms = _manifest.list_manifests(self.root)
                on_disk = ms[-1][0] if ms else 0
                self._last_step = max(self._last_step, on_disk) + 1
                return self._last_step
            self._last_step = max(self._last_step, int(step))
            return int(step)

    def _put_chunks(self, pieces) -> list:
        """The manifest's chunk list ({"h", "o", "n"}, in stream order)
        of an array's byte stream, cut into `pieces`: each piece stored
        by ChunkStore.put (hash, dedup, write) on _IO_THREADS threads at
        once, at most 4 pieces a thread in flight. The first error raises
        once the pieces in flight have ended; nothing commits without
        every chunk."""
        chunks, off, window = [], 0, 4 * _IO_THREADS
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            pending = []
            for piece in pieces:
                pending.append((pool.submit(self.chunks.put, piece), off,
                                len(piece)))
                off += len(piece)
                if len(pending) >= window:
                    f, o, n = pending.pop(0)
                    chunks.append({"h": f.result(), "o": o, "n": n})
            for f, o, n in pending:
                chunks.append({"h": f.result(), "o": o, "n": n})
        return chunks

    def _write_state(self, state: dict, step: int, meta, mode: str):
        t0 = time.perf_counter()
        arrays = {}
        for name, val in state.items():
            if isinstance(val, ShardedArray):
                src = val
                dtype, shape, nbytes = val.dtype, val.shape, val.nbytes
            else:
                arr = _host_array(val)
                src = ShardedArray([arr.reshape((-1,) if arr.ndim == 0
                                                else arr.shape)])
                dtype, shape, nbytes = arr.dtype, arr.shape, arr.nbytes
            chunks = self._put_chunks(src.iter_bytes(self.chunk_bytes))
            arrays[name] = {"dtype": np.dtype(dtype).str,
                            "shape": [int(s) for s in shape],
                            "nbytes": int(nbytes), "chunks": chunks}
        payload = {"step": int(step), "meta": meta, "arrays": arrays}
        _manifest.commit_manifest(self.root, payload)
        self._retention_gc()
        _SAVE_SECONDS.labels(mode=mode).observe(time.perf_counter() - t0)
        _SAVES.labels(mode=mode).inc()
        _flight.record("ckpt", "manifest_commit", step=int(step),
                       mode=mode, arrays=len(arrays),
                       seconds=round(time.perf_counter() - t0, 6))
        return payload

    def save(self, state: dict, step: int | None = None,
             meta=None) -> int:
        """Synchronous save; returns the committed step. ``state`` maps
        name → array-like (numpy / torch on any device, any dtype but
        bfloat16, any shape) or ShardedArray. ``meta`` is any JSON-serialisable extra (rides
        the manifest, CRC-covered)."""
        self.wait()  # manifests must commit in step order
        step = self._resolve_step(step)
        self._write_state(dict(state), step, meta, "sync")
        return step

    def save_part(self, state: dict, step: int, rank: int,
                  world: int, meta=None) -> str:
        """One rank's share of a multi-process save: write this rank's
        chunks, then publish a PARTIAL manifest (invisible to
        restore). ``step`` must be agreed across ranks; ``state``
        holds only the arrays this rank owns — ranks must partition
        the state by array name. Rank 0 calls ``merge_parts`` once
        every rank returned to commit the version."""
        arrays = {}
        for name, val in state.items():
            if isinstance(val, ShardedArray):
                src = val
                dtype, shape, nbytes = val.dtype, val.shape, val.nbytes
            else:
                arr = _host_array(val)
                src = ShardedArray([arr.reshape((-1,) if arr.ndim == 0
                                                else arr.shape)])
                dtype, shape, nbytes = arr.dtype, arr.shape, arr.nbytes
            chunks = self._put_chunks(src.iter_bytes(self.chunk_bytes))
            arrays[name] = {"dtype": np.dtype(dtype).str,
                            "shape": [int(s) for s in shape],
                            "nbytes": int(nbytes), "chunks": chunks}
        payload = {"step": int(step), "meta": meta, "arrays": arrays}
        path = _manifest.commit_part(self.root, payload, rank, world)
        _flight.record("ckpt", "part_commit", step=int(step),
                       rank=int(rank), world=int(world),
                       arrays=len(arrays))
        return path

    def merge_parts(self, step: int, world: int, meta=None) -> int:
        """Rank 0's commit of a multi-process save: merge the
        ``world`` parts of ``step`` into ONE manifest (the commit
        point), then run retention GC. Raises ManifestError (nothing
        commits, previous step stays restorable) if any part is
        missing, torn, or overlaps another rank's arrays."""
        self.wait()  # manifests must commit in step order
        with self._async_lock:
            self._last_step = max(self._last_step, int(step))
        written = self._parts_written(step)
        payload = _manifest.merge_parts(self.root, step, world,
                                        meta=meta)
        self._retention_gc(before=written)
        _SAVES.labels(mode="merged").inc()
        _flight.record("ckpt", "manifest_commit", step=int(step),
                       mode="merged", arrays=len(payload["arrays"]))
        return int(step)

    def _merge_when_ready(self, step: int, world: int, meta,
                          timeout: float) -> int:
        """Poll for all ``world`` parts of ``step``, then merge-commit.
        Unlike ``merge_parts`` this never calls ``wait()`` — it is the
        writer-thread body of ``merge_parts_async`` (queue FIFO already
        orders it after this store's own part write). A timeout leaves
        the parts uncommitted: restore degrades to the previous
        manifest bit-for-bit."""
        deadline = time.monotonic() + max(float(timeout), 0.0)
        while True:
            present = len(_manifest.list_parts(self.root, step))
            if present >= world:
                break
            if time.monotonic() >= deadline:
                raise _manifest.ManifestError(
                    f"merge step {step}: only {present}/{world} parts "
                    f"after {timeout}s — previous manifest stays the "
                    "restore target")
            time.sleep(0.02)
        with self._async_lock:
            self._last_step = max(self._last_step, int(step))
        written = self._parts_written(step)
        payload = _manifest.merge_parts(self.root, step, world,
                                        meta=meta)
        self._retention_gc(before=written)
        _SAVES.labels(mode="merged").inc()
        _flight.record("ckpt", "manifest_commit", step=int(step),
                       mode="merged", arrays=len(payload["arrays"]))
        return int(step)

    def _writer_loop(self, q):
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            kind, step, nbytes = item["kind"], item["step"], \
                item["nbytes"]
            self._save_started = time.monotonic()
            _flight.record("ckpt", "write_start", step=step,
                           bytes=nbytes, queued=q.qsize(), kind=kind)
            try:
                if kind == "full":
                    self._write_state(item["host"], step, item["meta"],
                                      "async")
                elif kind == "part":
                    self.save_part(item["host"], step, item["rank"],
                                   item["world"], meta=item["meta"])
                elif kind == "merge":
                    self._merge_when_ready(step, item["world"],
                                           item["meta"],
                                           item["timeout"])
                else:  # pragma: no cover - enqueue sites are in-file
                    raise ValueError(f"unknown writer item {kind!r}")
            except BaseException as e:  # surfaced on wait()/next save
                with self._async_lock:
                    self._async_error = e
                _flight.record("ckpt", "write_error", step=step,
                               kind=kind,
                               error=f"{type(e).__name__}: {e}")
            else:
                _flight.record(
                    "ckpt", "write_done", step=step, bytes=nbytes,
                    kind=kind,
                    seconds=round(
                        time.monotonic() - self._save_started, 6))
            finally:
                self._save_started = None
                with self._async_lock:
                    self._pending_bytes -= nbytes
                q.task_done()

    def _ensure_writer(self):
        """Start (once) the persistent background writer; re-raise any
        error the previous async item left behind."""
        with self._async_lock:
            err, self._async_error = self._async_error, None
            if self._queue is None:
                import queue as _queue
                self._queue = _queue.Queue(maxsize=2)
                t = threading.Thread(target=self._writer_loop,
                                     args=(self._queue,), daemon=True,
                                     name="ckpt-writer")
                t.start()
                # the writer loop must not outlive the store (daemon
                # thread regardless, so a full queue at GC just leaves
                # it to die with the process)
                import weakref
                weakref.finalize(self, _stop_writer, self._queue)
        if err is not None:
            raise err

    def _host_copy(self, state: dict) -> tuple[dict, int]:
        host = {}
        for name, val in state.items():
            if isinstance(val, ShardedArray):
                # pieces are host copies already (ctor asarray), but
                # guard aliasing with the training loop's buffers
                host[name] = ShardedArray(
                    [np.array(p, copy=True) for p in val.pieces])
            else:
                host[name] = np.array(_host_array(val), copy=True)
        return host, int(sum(v.nbytes for v in host.values()))

    def _enqueue(self, item: dict):
        with self._async_lock:
            self._pending_bytes += item["nbytes"]
        _flight.record("ckpt", "enqueue", step=item["step"],
                       bytes=item["nbytes"], kind=item["kind"],
                       queued=self._queue.qsize())
        self._queue.put(item)

    def save_async(self, state: dict, step: int | None = None,
                   meta=None) -> int:
        """Non-blocking save: host copies are taken NOW (so the caller
        may keep mutating/donating its arrays); chunk+manifest IO runs
        on a persistent background writer. Blocks only when TWO saves
        are already pending (backpressure — bounded host-copy memory).
        Returns the step that WILL commit; ``wait()`` (or the next
        save) surfaces writer errors."""
        self._ensure_writer()
        step = self._resolve_step(step)
        host, nbytes = self._host_copy(state)
        self._enqueue({"kind": "full", "host": host, "step": step,
                       "meta": meta, "nbytes": nbytes})
        return step

    def save_part_async(self, state: dict, step: int, rank: int,
                        world: int, meta=None) -> int:
        """``save_part`` off the step path: host copies now, partial
        manifest published by the background writer. Same backpressure
        and error-surfacing contract as ``save_async``. Nothing
        becomes restorable until rank 0 merges."""
        self._ensure_writer()
        with self._async_lock:
            self._last_step = max(self._last_step, int(step))
        host, nbytes = self._host_copy(state)
        self._enqueue({"kind": "part", "host": host, "step": int(step),
                       "rank": int(rank), "world": int(world),
                       "meta": meta, "nbytes": nbytes})
        return int(step)

    def merge_parts_async(self, step: int, world: int, meta=None,
                          timeout: float = 60.0) -> int:
        """Rank 0's asynchronous commit of a multi-process save: the
        background writer waits (up to ``timeout`` seconds) for all
        ``world`` parts of ``step`` then merge-commits. Queue FIFO
        guarantees this rank's own part lands first. On timeout the
        ManifestError surfaces on ``wait()``/next save and the
        PREVIOUS manifest remains the restore target bit-for-bit."""
        self._ensure_writer()
        self._enqueue({"kind": "merge", "step": int(step),
                       "world": int(world), "meta": meta,
                       "timeout": float(timeout), "nbytes": 0})
        return int(step)

    def wait(self):
        """Drain pending async saves and re-raise any writer error."""
        with self._async_lock:
            q = self._queue
        if q is not None:
            q.join()
        with self._async_lock:
            err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    # -- retention ------------------------------------------------------
    def _retention_gc(self, before: float | None = None):
        """Drop all but the newest ``keep`` manifests and the chunks
        only they referenced (``ChunkStore.gc``; ``before`` as there)."""
        if self.keep <= 0:
            return
        ms = _manifest.list_manifests(self.root)
        drop, hold = ms[:-self.keep], ms[-self.keep:]
        if not drop:
            return
        live: set[str] = set()
        for _s, path in hold:
            try:
                payload = _manifest.load_manifest(path)
            except _manifest.ManifestError:
                continue
            for ent in payload["arrays"].values():
                live.update(c["h"] for c in ent["chunks"])
        for _s, path in drop:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.chunks.gc(live, before)

    def _parts_written(self, step: int) -> float | None:
        """When the earliest part of ``step`` was written: every rank
        wrote its part of ``step`` before it started a later save, so
        the chunks and temp files of saves still in flight are all
        younger (the cut-off of a merge's retention GC)."""
        try:
            return min(os.stat(path).st_mtime for _r, path in
                       _manifest.list_parts(self.root, step))
        except (OSError, ValueError):
            return None

    # -- restore --------------------------------------------------------
    def latest_manifest(self, step: int | None = None) -> dict:
        return _manifest.load_latest(self.root, step)

    def restore(self, step: int | None = None,
                names=None) -> tuple[dict, object]:
        """(arrays, meta) of the newest committed step (or ``step``).
        ``names`` restricts to a subset without reading the rest. Every
        chunk of every array is read and verified on a thread pool
        straight into its array's buffer."""
        t0 = time.perf_counter()
        payload = self.latest_manifest(step)
        ents = {name: ent for name, ent in payload["arrays"].items()
                if names is None or name in names}
        bufs = {name: np.empty(int(ent["nbytes"]), np.uint8)
                for name, ent in ents.items()}
        self._fill([job for name, ent in ents.items()
                    for job in self._jobs(ent, 0, int(ent["nbytes"]),
                                          bufs[name])])
        out = {name: bufs[name].view(np.dtype(ent["dtype"]))
               .reshape(tuple(ent["shape"])) for name, ent in ents.items()}
        _RESTORE_SECONDS.observe(time.perf_counter() - t0)
        return out, payload.get("meta")

    def _jobs(self, ent: dict, lo: int, hi: int, buf: np.ndarray) -> list:
        """(digest, chunk length, chunk's byte range in the array's
        stream, where it lands in `buf`) of every chunk overlapping
        bytes [lo, hi) of an array's stream, `buf` holding those bytes;
        raises ChunkError unless the chunks cover the range."""
        jobs, covered = [], 0
        for c in ent["chunks"]:
            co, cn = int(c["o"]), int(c["n"])
            if co + cn <= lo or co >= hi:
                continue
            a, b = max(lo, co), min(hi, co + cn)
            jobs.append((c["h"], cn, (a - co, b - co), buf[a - lo:b - lo]))
            covered += b - a
        if covered != hi - lo:
            from .chunks import ChunkError
            raise ChunkError(
                f"array bytes [{lo},{hi}) incomplete: got {covered}")
        return jobs

    def _fill(self, jobs: list):
        """Run `_jobs`' reads: a chunk wholly inside the range is read
        and verified in place, one that straddles its ends through a
        scratch buffer (the whole chunk is hashed either way). Chunks
        are read by _IO_THREADS threads at once; the first error raises
        once every read has ended."""
        def one(job):
            digest, cn, (a, b), dst = job
            if b - a == cn:
                self.chunks.read_into(digest, dst)
            else:
                tmp = np.empty(cn, np.uint8)
                self.chunks.read_into(digest, tmp)
                dst[:] = tmp[a:b]

        if len(jobs) <= 1:
            for job in jobs:
                one(job)
            return
        with ThreadPoolExecutor(min(_IO_THREADS, len(jobs))) as pool:
            futures = [pool.submit(one, job) for job in jobs]
        for f in futures:
            f.result()

    def _read_range(self, ent: dict, lo: int, hi: int) -> np.ndarray:
        """Bytes [lo, hi) of an array's global stream as a uint8 array,
        reading only the chunks that overlap."""
        buf = np.empty(hi - lo, np.uint8)
        self._fill(self._jobs(ent, lo, hi, buf))
        return buf

    def _assemble(self, ent: dict) -> np.ndarray:
        return self._read_range(ent, 0, int(ent["nbytes"])) \
            .view(np.dtype(ent["dtype"])).reshape(tuple(ent["shape"]))

    def restore_array(self, name: str, step: int | None = None) \
            -> np.ndarray:
        payload = self.latest_manifest(step)
        return self._assemble(payload["arrays"][name])

    def materialize(self, ent: dict) -> np.ndarray:
        """Assemble one manifest ``arrays`` entry (as returned by
        ``latest_manifest``) into an ndarray — the entry-level restore
        primitive for layers that walk a manifest once and read many
        arrays (cluster_ckpt's resize path)."""
        return self._assemble(ent)

    def read_rows(self, ent: dict, row_lo: int, row_hi: int) \
            -> np.ndarray:
        """Axis-0 rows [row_lo, row_hi) of one manifest entry, reading
        only the chunks overlapping that byte span. Scalars cannot be
        row-addressed."""
        shape = tuple(ent["shape"])
        if not shape:
            raise ValueError("read_rows: scalar entries have no rows")
        dtype = np.dtype(ent["dtype"])
        row_bytes = dtype.itemsize * int(np.prod(shape[1:],
                                                 dtype=np.int64))
        if not 0 <= row_lo <= row_hi <= shape[0]:
            raise ValueError(
                f"read_rows: [{row_lo},{row_hi}) outside [0,{shape[0]}]")
        if row_lo == row_hi:
            return np.empty((0,) + shape[1:], dtype=dtype)
        return self._read_range(ent, row_lo * row_bytes,
                                row_hi * row_bytes) \
            .view(dtype).reshape((row_hi - row_lo,) + shape[1:])

    def restore_shard(self, name: str, shard: int, num_shards: int,
                      step: int | None = None) -> np.ndarray:
        """Shard ``shard`` of ``num_shards`` of axis 0 (np.array_split
        partition — uneven leading dims round-robin the remainder),
        reading only the overlapping chunks. This is the resharding
        path: the saved layout is irrelevant, only the chunk grid
        matters."""
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} outside [0, {num_shards})")
        payload = self.latest_manifest(step)
        ent = payload["arrays"][name]
        shape = tuple(ent["shape"])
        if not shape:
            raise ValueError(f"{name} is a scalar — nothing to shard")
        dtype = np.dtype(ent["dtype"])
        row_bytes = dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))
        n = shape[0]
        base, rem = divmod(n, num_shards)
        r0 = shard * base + min(shard, rem)
        rows = base + (1 if shard < rem else 0)
        return self._read_range(ent, r0 * row_bytes,
                                (r0 + rows) * row_bytes) \
            .view(dtype).reshape((rows,) + shape[1:])

    def steps(self) -> list[int]:
        return [s for s, _p in _manifest.list_manifests(self.root)]

    @staticmethod
    def exists(root: str) -> bool:
        """Is there a committed checkpoint under ``root``?"""
        return bool(_manifest.list_manifests(root))
