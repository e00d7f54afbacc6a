"""Content-addressed chunk store — the byte-level tier of the
checkpoint subsystem.

Arrays are split into fixed-size chunks (store.py owns the grid); each
chunk is keyed by the SHA-256 of its bytes and written once under
``<root>/chunks/<hh>/<digest>`` (sha256 over blake2b deliberately:
OpenSSL rides SHA-NI/crypto extensions on modern hosts, ~1.3 GB/s
single-thread, and hashing is the save path's compute cost). A chunk that already exists is never
rewritten — re-referencing it from a new manifest is free, which is
what makes per-step incremental checkpoints cost O(changed bytes)
instead of O(state bytes) (the Orbax/TensorStore role, reduced to a
local content-addressed blob store).

Durability contract: a chunk file is visible under its final name only
after a same-directory ``os.replace`` of a fully written temp file, so
a reader (or a crash-restore) can never observe a torn chunk; restore
re-hashes every chunk it reads (``get(verify=True)``) so silent disk
corruption surfaces as ``ChunkError``, not as garbage parameters.

No pickle anywhere (scripts/check_no_wire_pickle.py scans this tree):
chunk files are raw bytes, addressed by hash.
"""
from __future__ import annotations

import hashlib
import os
import threading

from ..observability import registry as _obs

__all__ = ["ChunkError", "ChunkStore"]

_CHUNKS_WRITTEN = _obs.counter(
    "paddle_tpu_ckpt_chunks_written_total",
    "content-addressed chunks physically written to storage")
_DEDUP_HITS = _obs.counter(
    "paddle_tpu_ckpt_chunks_dedup_hits_total",
    "chunk puts answered by an already-stored identical chunk")
_BYTES_WRITTEN = _obs.counter(
    "paddle_tpu_ckpt_bytes_written_total",
    "checkpoint bytes physically written, by tier", ["tier"])
_GC_CHUNKS = _obs.counter(
    "paddle_tpu_ckpt_gc_chunks_total",
    "unreferenced chunks deleted by retention GC")


class ChunkError(RuntimeError):
    """Missing or corrupt chunk on the restore path."""


def digest_of(data) -> str:
    return hashlib.sha256(data).hexdigest()


class ChunkStore:
    """Content-addressed blobs under ``<root>/chunks/``.

    Thread-safe: concurrent writers of the SAME digest race benignly
    (identical bytes, last rename wins); the stats counters are locked.
    """

    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "chunks")
        self._lock = threading.Lock()
        self._tmp_seq = 0
        # process-local accounting (registry counters are global; tests
        # and bench read the per-store numbers)
        self.chunks_written = 0
        self.dedup_hits = 0
        self.bytes_written = 0

    def _path(self, digest: str) -> str:
        return os.path.join(self.dir, digest[:2], digest)

    def has(self, digest: str) -> bool:
        return os.path.isfile(self._path(digest))

    def put(self, data) -> str:
        """Store bytes, return their digest. An existing identical
        chunk is re-referenced, not rewritten (the dedup hit the
        incremental-save economics stand on)."""
        data = bytes(data) if not isinstance(data, (bytes, bytearray)) \
            else data
        digest = digest_of(data)
        path = self._path(digest)
        if os.path.isfile(path) and self._touch(path):
            with self._lock:
                self.dedup_hits += 1
            _DEDUP_HITS.inc()
            # crash-test hook: dedup'd bytes count as save progress too
            # (a mostly-unchanged incremental save writes few NEW bytes
            # but must still be killable at a deterministic point)
            from ..distributed.fleet.runtime.fault_injection import \
                injector
            inj = injector()
            if inj.active:
                inj.maybe_kill_bytes(len(data))
            return digest
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        with self._lock:
            self._tmp_seq += 1
            tmp = f"{path}.tmp.{os.getpid()}.{self._tmp_seq}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        # crash-test hook: the writer process can be armed to die after
        # N payload bytes (fault_injection kill-after-bytes), modelling
        # a crash mid-save with some chunks on disk and no manifest
        from ..distributed.fleet.runtime.fault_injection import injector
        inj = injector()
        if inj.active:
            inj.maybe_kill_bytes(len(data))
        os.replace(tmp, path)
        with self._lock:
            self.chunks_written += 1
            self.bytes_written += len(data)
        _CHUNKS_WRITTEN.inc()
        _BYTES_WRITTEN.labels(tier="chunk").inc(len(data))
        return digest

    @staticmethod
    def _touch(path: str) -> bool:
        """Stamp a re-referenced chunk with the time, as a write would
        (``gc(before=)`` keeps what a save in flight has touched); False
        when it was collected meanwhile and must be written again."""
        try:
            os.utime(path)
        except FileNotFoundError:
            return False
        return True

    def get(self, digest: str, verify: bool = True) -> bytes:
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise ChunkError(f"chunk {digest} missing from {self.dir}")
        if verify and digest_of(data) != digest:
            raise ChunkError(f"chunk {digest} corrupt on disk "
                             f"(content hash mismatch)")
        return data

    def read_into(self, digest: str, buf, verify: bool = True) -> None:
        """Read chunk `digest` into the writable buffer `buf`, which must
        be exactly the chunk's length, and (by default) re-hash it there:
        ``get`` without the bytes object, for readers that assemble
        arrays in place. Both the read and the hash release the GIL, so
        threads reading chunks overlap."""
        path = self._path(digest)
        mv = memoryview(buf).cast("B")
        try:
            f = open(path, "rb", buffering=0)
        except FileNotFoundError:
            raise ChunkError(f"chunk {digest} missing from {self.dir}")
        with f:
            size = os.fstat(f.fileno()).st_size
            if size != len(mv):
                raise ChunkError(f"chunk {digest} length {size} != "
                                 f"expected {len(mv)}")
            got = 0
            while got < size:
                n = f.readinto(mv[got:])
                if not n:
                    break
                got += n
        if got != size:
            raise ChunkError(f"chunk {digest} short read: {got} of {size}")
        if verify and digest_of(mv) != digest:
            raise ChunkError(f"chunk {digest} corrupt on disk "
                             f"(content hash mismatch)")

    def all_digests(self) -> set[str]:
        out: set[str] = set()
        if not os.path.isdir(self.dir):
            return out
        for sub in os.listdir(self.dir):
            subdir = os.path.join(self.dir, sub)
            if not os.path.isdir(subdir):
                continue
            for fn in os.listdir(subdir):
                if ".tmp." not in fn:
                    out.add(fn)
        return out

    def gc(self, live: set[str], before: float | None = None) -> int:
        """Delete chunks not referenced by any retained manifest (and
        any stale temp files from crashed writers). With ``before`` (a
        wall-clock time), files written or re-referenced at or after it
        stay: other processes sharing the store may have a save in
        flight whose part does not reference them yet. Returns the
        number of chunks deleted."""
        n = 0
        if not os.path.isdir(self.dir):
            return 0
        for sub in os.listdir(self.dir):
            subdir = os.path.join(self.dir, sub)
            if not os.path.isdir(subdir):
                continue
            for fn in os.listdir(subdir):
                if ".tmp." in fn or fn not in live:
                    path = os.path.join(subdir, fn)
                    try:
                        if before is not None \
                                and os.stat(path).st_mtime >= before:
                            continue
                        os.unlink(path)
                    except OSError:
                        continue
                    if ".tmp." not in fn:
                        n += 1
        if n:
            _GC_CHUNKS.inc(n)
        return n
