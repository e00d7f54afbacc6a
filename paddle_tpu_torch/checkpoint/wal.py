"""Row-level write-ahead journal.

One append-only file of self-delimiting, CRC'd records. This is the
layer that closes the ROADMAP item "a delta still rewrites the whole
dirty table": a PS push journals only the ROWS it touched
(``append_rows(table, idx, values)`` — O(touched rows) bytes), and a
restore replays ``base snapshot + journal`` back to the exact live
state. Compaction (owner-triggered past a byte threshold) folds the
journal into a fresh base and starts a new file.

Record layout (little-endian, data-only — no pickle, scanned by
scripts/check_no_wire_pickle.py):

    magic u32 | crc32(payload) u32 | payload_len u64 | payload
    payload := jlen u32 | header JSON | idx bytes | values bytes
               | extra bytes

The header JSON carries kind ("rows" | "mark"), table metadata
(dim/init_std/seed — enough to recreate the table from nothing), array
dtypes/counts, the RPC request id (exactly-once dedup survives a
crash-restore), and the extra-blob length (an opaque reply blob the PS
tier round-trips; the journal never interprets it).

Torn-tail semantics: a crash mid-append leaves a partial last record;
``replay`` verifies magic + length + CRC per record and STOPS at the
first bad one — everything before it is committed, everything after is
the crash. Appends go through one ``os.write`` per record and are
flushed to the OS before returning (surviving process death); set
``PADDLE_TPU_WAL_FSYNC=1`` to also fsync per append (surviving power
loss, at write-through cost).
"""
from __future__ import annotations

import json
import os
import struct
import threading
import zlib

import numpy as np

from ..observability import flight as _flight, registry as _obs

__all__ = ["RowJournal", "replay_file", "committed_length",
           "WAL_MAGIC"]

WAL_MAGIC = 0x5054574C  # "PTWL"
_REC = struct.Struct("<IIQ")  # magic, crc32(payload), payload_len
_JLEN = struct.Struct("<I")

_ROWS_APPENDED = _obs.counter(
    "paddle_tpu_ckpt_wal_rows_appended_total",
    "table rows appended to row-level WAL journals")
_WAL_RECORDS = _obs.counter(
    "paddle_tpu_ckpt_wal_records_total",
    "records appended to row-level WAL journals", ["kind"])
_WAL_COMPACTIONS = _obs.counter(
    "paddle_tpu_ckpt_wal_compactions_total",
    "WAL journals folded into a fresh base snapshot")


def _encode(header: dict, idx: np.ndarray | None,
            values: np.ndarray | None, extra: bytes) -> bytes:
    jb = json.dumps(header, sort_keys=True,
                    separators=(",", ":")).encode("utf-8")
    parts = [_JLEN.pack(len(jb)), jb]
    if idx is not None:
        parts.append(idx.tobytes())
    if values is not None:
        parts.append(values.tobytes())
    if extra:
        parts.append(extra)
    payload = b"".join(parts)
    return _REC.pack(WAL_MAGIC, zlib.crc32(payload) & 0xFFFFFFFF,
                     len(payload)) + payload


class RowJournal:
    """Appender for one WAL file (thread-safe; one writer process).

    ``recover=True`` (re-opening a journal a previous incarnation may
    have died writing) truncates any torn tail BEFORE appending:
    records appended after garbage would sit beyond the point every
    future replay stops at — silently un-replayable durability."""

    def __init__(self, path: str, fsync: bool | None = None,
                 recover: bool = False):
        self.path = path
        self.fsync = fsync if fsync is not None else \
            os.environ.get("PADDLE_TPU_WAL_FSYNC", "") not in ("", "0")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        if recover and os.path.exists(path):
            good = committed_length(path)
            if good < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(good)
        self._lock = threading.Lock()
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self.bytes_written = 0
        self.rows_appended = 0
        self.records = 0

    def _append(self, record: bytes, rows: int, kind: str) -> int:
        with self._lock:
            if self._fd is None:
                raise ValueError(f"journal {self.path} is closed")
            os.write(self._fd, record)
            if self.fsync:
                os.fsync(self._fd)
            self.bytes_written += len(record)
            self.rows_appended += rows
            self.records += 1
        if rows:
            _ROWS_APPENDED.inc(rows)
        _WAL_RECORDS.labels(kind=kind).inc()
        from .chunks import _BYTES_WRITTEN
        _BYTES_WRITTEN.labels(tier="wal").inc(len(record))
        return len(record)

    def append_rows(self, table: str, idx, values, *, dim: int | None
                    = None, init_std: float = 0.01, seed: int = 0,
                    req_id: int = 0, extra: bytes = b"") -> int:
        """Journal the post-apply VALUES of the touched rows of one
        table. Replay = ensure-rows-exist + assign, which is idempotent
        and (replayed in append order from the same base) reproduces
        the live table's data, key→slot index, and RNG stream exactly.
        Returns bytes appended — O(len(idx) · dim), never O(table)."""
        idx = np.ascontiguousarray(np.asarray(idx, np.int64).ravel())
        values = np.ascontiguousarray(np.asarray(values, np.float32))
        values = values.reshape(len(idx), -1)
        header = {"kind": "rows", "table": table,
                  "dim": int(dim if dim is not None
                             else values.shape[1]),
                  "init_std": float(init_std), "seed": int(seed),
                  "n": int(len(idx)), "kdt": idx.dtype.str,
                  "vdt": values.dtype.str, "vshape": list(values.shape),
                  "req_id": int(req_id), "xlen": len(extra)}
        return self._append(_encode(header, idx, values, extra),
                            len(idx), "rows")

    def append_mark(self, req_id: int, extra: bytes = b"") -> int:
        """Journal a dedup-only record: the request id (and its opaque
        reply blob) of a mutating op whose state effects were journaled
        elsewhere — a crash-restore re-arms exactly-once for it."""
        header = {"kind": "mark", "req_id": int(req_id),
                  "xlen": len(extra)}
        return self._append(_encode(header, None, None, extra), 0,
                            "mark")

    def close(self):
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    @staticmethod
    def note_compaction():
        _WAL_COMPACTIONS.inc()
        _flight.record("ckpt", "wal_compaction")


def _walk(blob: bytes):
    """Yield (record, end_offset) for every committed record, stopping
    at the first torn/corrupt one (the crash point)."""
    off = 0
    while off + _REC.size <= len(blob):
        magic, crc, plen = _REC.unpack_from(blob, off)
        if magic != WAL_MAGIC:
            return  # torn tail / foreign bytes: stop
        start = off + _REC.size
        if start + plen > len(blob):
            return  # partial last record (crash mid-append)
        payload = blob[start:start + plen]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return  # corrupt record: everything after is suspect
        (jlen,) = _JLEN.unpack_from(payload, 0)
        header = json.loads(payload[_JLEN.size:_JLEN.size + jlen]
                            .decode("utf-8"))
        rec = dict(header)
        p = _JLEN.size + jlen
        if header["kind"] == "rows":
            n = int(header["n"])
            kdt = np.dtype(header["kdt"])
            idx = np.frombuffer(payload, kdt, n, p)
            p += n * kdt.itemsize
            vdt = np.dtype(header["vdt"])
            vshape = tuple(header["vshape"])
            nv = int(np.prod(vshape)) if vshape else 1
            rec["idx"] = idx
            rec["values"] = np.frombuffer(payload, vdt, nv,
                                          p).reshape(vshape)
            p += nv * vdt.itemsize
        rec["extra"] = payload[p:p + int(header.get("xlen", 0))]
        off = start + plen
        yield rec, off


def replay_file(path: str):
    """Yield committed records from a WAL file, stopping cleanly at the
    first torn/corrupt record (the crash point). Each yielded dict has
    the header fields plus ``idx``/``values`` ndarrays (rows records)
    and ``extra`` bytes."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return
    for rec, _end in _walk(blob):
        yield rec


def committed_length(path: str) -> int:
    """Byte offset just past the last committed record (0 for a
    missing/empty/corrupt-from-the-start file) — the truncation point
    for reopening a journal after a crash."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except FileNotFoundError:
        return 0
    end = 0
    for _rec, end in _walk(blob):
        pass
    return end
