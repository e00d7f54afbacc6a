"""Embedded append-only time-series store for the fleet collector
(counterpart of ``paddle_tpu/observability/timeseries.py``: the block
files are the same bytes, so a directory either package wrote answers
the other's queries).

The telemetry collector is point-in-time: ``tel_fleet`` shows "now" and the
flight recorder shows "recently". This module gives the fleet history
— every metric snapshot an agent pushes (`tel_push` ride-along
registry dumps plus per-push fleet summaries) lands in an embedded
TSDB the collector hosts, so "what did p99 TTFT look like over the
last hour, per tenant?" is a `tsdb_query` away and the alert engine
(`observability.alerts`) has something to evaluate burn rates over.

Storage model (the checkpoint WAL's idiom):

  * ``active.tsb`` — append-only CRC'd records
    (``magic | crc32(payload) | len | payload``), one record per
    ingested batch. A torn tail (crash mid-write) is detected by the
    same magic/length/CRC walk the checkpoint WAL uses and truncated
    on reopen — committed history survives, the torn record does not.
  * sealed blocks — when the active file exceeds the block budget its
    committed records are downsampled to the 10s tier and rewritten
    as ``block-<seq>.tsb`` via tmp + fsync + ``os.rename`` (atomic
    publish; a crash leaves either the old active or the sealed
    block, never a half block).
  * retention — when total on-disk bytes exceed the budget the oldest
    sealed block is first compacted to the 5m tier
    (``block-<seq>c.tsb``, same tmp+rename publish) and only deleted
    once already compacted; history degrades in resolution before it
    disappears.

In memory each series keeps three query tiers — raw points over a
short window, 10s last-sample buckets, 5m last-sample buckets — so
queries pick the finest tier that still covers the asked-for range.
Last-sample-per-bucket downsampling is exact for cumulative counters
and cumulative histogram buckets (the only shapes the registry
exports), which is what keeps ``rate()`` and ``quantile()`` honest
after compaction.

Histograms are stored bucket-aware (cumulative counts + sum + count
per sample), so p50/p99 over any past window is computable after the
fact: ``quantile()`` takes the elementwise bucket delta across the
window and runs the same nearest-bucket estimate the collector's live
summary uses.

A ``TimeSeriesDB(dir_=None)`` is memory-only (tests, hosted
collectors without a data dir); set ``PADDLE_TPU_TSDB_DIR`` (or
the launcher's ``--tsdb-dir``) for durable history.
"""
from __future__ import annotations

import json
import math
import os
import re
import struct
import threading
import zlib
from collections import deque

from . import registry as _obs

__all__ = ["TimeSeriesDB", "series_key", "hist_quantile",
           "TSB_MAGIC", "committed_records"]

# record framing: magic u32 | crc32(payload) u32 | payload_len u64
# (the checkpoint WAL's layout with its own magic, so a stray WAL file
# in the TSDB dir is rejected rather than replayed)
TSB_MAGIC = 0x50545342  # "PTSB"
_REC = struct.Struct("<IIQ")
_MAX_RECORD = 64 * 1024 * 1024

_BLOCK_RE = re.compile(r"^block-(\d+)(c?)\.tsb$")

_SAMPLES = _obs.counter(
    "paddle_tpu_tsdb_samples_total",
    "samples appended to the collector time-series store")
_SERIES = _obs.gauge(
    "paddle_tpu_tsdb_series",
    "live series tracked by the collector time-series store")
_DISK = _obs.gauge(
    "paddle_tpu_tsdb_bytes_on_disk",
    "bytes held by TSDB block files (active + sealed)")
_SEALED = _obs.counter(
    "paddle_tpu_tsdb_blocks_sealed_total",
    "active TSDB segments sealed into 10s-tier blocks")
_COMPACTED = _obs.counter(
    "paddle_tpu_tsdb_blocks_compacted_total",
    "sealed TSDB blocks compacted to the 5m tier under retention")
_DELETED = _obs.counter(
    "paddle_tpu_tsdb_blocks_deleted_total",
    "TSDB blocks deleted by byte-budget retention")
_TORN = _obs.counter(
    "paddle_tpu_tsdb_torn_tail_truncated_total",
    "torn TSDB tails truncated on reopen (crash mid-append)")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def series_key(name: str, labels: dict | None) -> str:
    """Canonical ``name{k="v",...}`` identity (sorted label keys)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def hist_quantile(buckets, cumulative, q: float) -> float | None:
    """Nearest-bucket quantile from cumulative histogram counts (upper
    bound of the first bucket reaching rank q; same estimate as the
    collector's live summary, so history agrees with ``tel_fleet``)."""
    if not cumulative or cumulative[-1] <= 0:
        return None
    rank = q * cumulative[-1]
    for i, c in enumerate(cumulative):
        if c >= rank:
            return float(buckets[i]) if i < len(buckets) \
                else float(buckets[-1])
    return float(buckets[-1])


def committed_records(blob: bytes):
    """Yield ``(payload_bytes, end_offset)`` for each committed record;
    stops at the first bad magic / short frame / CRC mismatch — the
    checkpoint WAL's torn-tail walk."""
    off = 0
    n = len(blob)
    while off + _REC.size <= n:
        magic, crc, length = _REC.unpack_from(blob, off)
        if magic != TSB_MAGIC or length > _MAX_RECORD:
            return
        start = off + _REC.size
        end = start + length
        if end > n:
            return
        payload = blob[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return
        yield payload, end
        off = end


def _encode_record(payload: dict) -> bytes:
    raw = json.dumps(payload, separators=(",", ":"),
                     sort_keys=True).encode("utf-8")
    return _REC.pack(TSB_MAGIC, zlib.crc32(raw) & 0xFFFFFFFF,
                     len(raw)) + raw


class _Series:
    """One series: identity + the three in-memory query tiers."""

    __slots__ = ("key", "name", "labels", "kind", "buckets",
                 "raw", "mid", "coarse", "first_t", "last_t")

    def __init__(self, key, name, labels, kind, buckets=None):
        self.key = key
        self.name = name
        self.labels = dict(labels or {})
        self.kind = kind
        self.buckets = list(buckets) if buckets else None
        self.raw: deque = deque()    # (t, value), append order = time
        self.mid: dict = {}          # 10s bucket start -> (t, value)
        self.coarse: dict = {}       # 5m bucket start -> (t, value)
        self.first_t: float | None = None
        self.last_t: float | None = None

    def append(self, t: float, value, raw_window: float,
               mid_keep: int, coarse_keep: int):
        if self.first_t is None or t < self.first_t:
            self.first_t = t
        if self.last_t is None or t > self.last_t:
            self.last_t = t
        self.raw.append((t, value))
        while self.raw and self.raw[0][0] < t - raw_window:
            self.raw.popleft()
        self.mid[int(t // 10.0) * 10] = (t, value)
        self.coarse[int(t // 300.0) * 300] = (t, value)
        # bucket dicts grow once per bucket, so the trim triggers at
        # most once per bucket rollover — O(n log n) is fine here
        if len(self.mid) > mid_keep:
            for b in sorted(self.mid)[:len(self.mid) - mid_keep]:
                del self.mid[b]
        if len(self.coarse) > coarse_keep:
            for b in sorted(self.coarse)[:len(self.coarse)
                                         - coarse_keep]:
                del self.coarse[b]

    def points(self, start: float, end: float) -> list:
        """Time-ordered (t, value) over [start, end], finest tier
        winning where tiers overlap."""
        raw_first = self.raw[0][0] if self.raw else math.inf
        mid_pts = [self.mid[b] for b in sorted(self.mid)]
        mid_first = mid_pts[0][0] if mid_pts else math.inf
        out = [p for b in sorted(self.coarse)
               for p in (self.coarse[b],) if p[0] < mid_first]
        out.extend(p for p in mid_pts if p[0] < raw_first)
        out.extend(self.raw)
        return [p for p in out if start <= p[0] <= end]

    def value_at(self, t: float):
        """Last value at or before t (None if the series starts
        later) — the window-edge read rate()/quantile() build on."""
        prev = None
        for pt, pv in self.points(-math.inf, t):
            prev = pv
        return prev


def _scalar(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


class TimeSeriesDB:
    """See module docstring. Thread-safe behind one lock; every
    public query returns plain copies, so callers never hold it."""

    def __init__(self, dir_: str | None = None,
                 retention_bytes: int | None = None,
                 block_bytes: int | None = None,
                 raw_window_s: float | None = None,
                 mid_keep: int = 2160, coarse_keep: int = 2016):
        if dir_ is None:
            dir_ = os.environ.get("PADDLE_TPU_TSDB_DIR") or None
        if retention_bytes is None:
            retention_bytes = int(_env_float(
                "PADDLE_TPU_TSDB_RETENTION_BYTES", 64 * 2**20))
        if block_bytes is None:
            block_bytes = int(_env_float(
                "PADDLE_TPU_TSDB_BLOCK_BYTES", 1 * 2**20))
        if raw_window_s is None:
            raw_window_s = _env_float("PADDLE_TPU_TSDB_RAW_WINDOW",
                                      900.0)
        self.dir = dir_
        self.retention_bytes = max(4096, int(retention_bytes))
        self.block_bytes = max(4096, int(block_bytes))
        self.raw_window_s = max(1.0, float(raw_window_s))
        self.mid_keep = max(16, int(mid_keep))
        self.coarse_keep = max(16, int(coarse_keep))
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._fd: int | None = None
        self._active_bytes = 0
        self._block_sizes: dict[str, int] = {}  # fname -> bytes
        self._seq = 0
        self._meta_written: set[str] = set()
        self.counts = {"appended": 0, "sealed": 0, "compacted": 0,
                       "deleted": 0, "torn": 0, "replayed": 0}
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            with self._lock:
                self._open_locked()

    # -- disk: open / replay -------------------------------------------
    def _blocks_locked(self) -> list[tuple[int, bool, str]]:
        """(seq, compacted, fname) for every sealed block, seq order.
        When both the raw and the compacted block of one seq exist, a
        crash hit between the compaction rename and the unlink: the
        compacted block is the committed one, the raw original goes."""
        found: dict[int, dict[bool, str]] = {}
        for fn in os.listdir(self.dir):
            m = _BLOCK_RE.match(fn)
            if m:
                found.setdefault(int(m.group(1)), {})[
                    m.group(2) == "c"] = fn
        out = []
        for seq in sorted(found):
            pair = found[seq]
            if True in pair and False in pair:
                try:
                    os.unlink(os.path.join(self.dir, pair[False]))
                except OSError:
                    pass
                del pair[False]
            compacted = True in pair
            out.append((seq, compacted, pair[compacted]))
        return out

    def _open_locked(self):
        for seq, compacted, fn in self._blocks_locked():
            path = os.path.join(self.dir, fn)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                continue
            self._block_sizes[fn] = len(blob)
            for payload, _ in committed_records(blob):
                self._replay_payload(payload)
            self._seq = max(self._seq, seq + 1)
        active = os.path.join(self.dir, "active.tsb")
        blob = b""
        if os.path.exists(active):
            with open(active, "rb") as f:
                blob = f.read()
        good = 0
        for payload, end in committed_records(blob):
            self._replay_payload(payload)
            good = end
        if good < len(blob):
            os.truncate(active, good)
            self.counts["torn"] += 1
            _TORN.inc()
        self._fd = os.open(active,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self._active_bytes = good
        self._publish_gauges_locked()

    def _replay_payload(self, payload: bytes):
        try:
            rec = json.loads(payload)
        except ValueError:
            return
        for key, meta in (rec.get("m") or {}).items():
            self._series_for_locked(
                key, meta.get("name") or key,
                meta.get("labels") or {},
                meta.get("kind") or "gauge", meta.get("b"))
        t = float(rec.get("t") or 0.0)
        for key, enc in (rec.get("s") or {}).items():
            s = self._series.get(key)
            if s is None:
                s = self._series_for_locked(key, key, {}, "gauge",
                                            None)
            s.append(t, self._decode_value(enc), self.raw_window_s,
                     self.mid_keep, self.coarse_keep)
            self.counts["replayed"] += 1

    @staticmethod
    def _decode_value(enc):
        if isinstance(enc, dict):
            return (tuple(_scalar(c) for c in enc.get("c") or ()),
                    _scalar(enc.get("s")), _scalar(enc.get("n")))
        return _scalar(enc)

    @staticmethod
    def _encode_value(v):
        if isinstance(v, tuple):
            return {"c": list(v[0]), "s": v[1], "n": v[2]}
        return v

    # -- ingest --------------------------------------------------------
    def _series_for_locked(self, key, name, labels, kind, buckets):
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series(key, name, labels, kind,
                                            buckets)
        return s

    def append(self, t: float, entries) -> int:
        """Append one batch. ``entries``: iterable of
        ``(name, labels, kind, value, buckets)`` where value is a
        float (counter/gauge) or ``(cumulative, sum, count)`` for a
        histogram. Returns the number of samples appended."""
        n = 0
        with self._lock:
            samples = {}
            meta = {}
            for name, labels, kind, value, buckets in entries:
                key = series_key(name, labels)
                s = self._series_for_locked(key, name, labels, kind,
                                            buckets)
                s.append(float(t), value, self.raw_window_s,
                         self.mid_keep, self.coarse_keep)
                samples[key] = self._encode_value(value)
                if self._fd is not None \
                        and key not in self._meta_written:
                    meta[key] = self._meta_locked(s)
                    self._meta_written.add(key)
                n += 1
            if n == 0:
                return 0
            self.counts["appended"] += n
            _SAMPLES.inc(n)
            if self._fd is not None:
                rec = {"t": float(t), "s": samples}
                if meta:
                    rec["m"] = meta
                buf = _encode_record(rec)
                os.write(self._fd, buf)
                self._active_bytes += len(buf)
                if self._active_bytes >= self.block_bytes:
                    self._seal_locked()
                    self._enforce_retention_locked()
            self._publish_gauges_locked()
        return n

    @staticmethod
    def _meta_locked(s: _Series) -> dict:
        m = {"name": s.name, "labels": s.labels, "kind": s.kind}
        if s.buckets:
            m["b"] = s.buckets
        return m

    def ingest_dump(self, host: str, pid, role: str, dump: dict,
                    ts: float | None = None) -> int:
        """One full registry dump (the agent's every-Nth-flush
        ride-along). host/pid/role become labels — the sample's own
        labels win on collision — so fleet-wide queries sum across
        processes and per-process history stays addressable."""
        t = float(ts if ts is not None
                  else dump.get("time") or 0.0)
        base = {"host": str(host), "pid": str(pid),
                "role": str(role)}
        entries = []
        for m in dump.get("metrics", ()):
            kind = m.get("kind") or "gauge"
            buckets = m.get("buckets")
            for smp in m.get("samples", ()):
                labels = dict(base)
                labels.update(smp.get("labels") or {})
                if kind == "histogram":
                    v = (tuple(_scalar(c)
                               for c in smp.get("cumulative") or ()),
                         _scalar(smp.get("sum")),
                         _scalar(smp.get("count")))
                else:
                    if smp.get("value") is None:
                        continue
                    v = _scalar(smp.get("value"))
                entries.append((m["name"], labels, kind, v, buckets))
        return self.append(t, entries)

    def ingest_scalars(self, t: float, values: dict,
                       labels: dict | None = None,
                       kind: str = "gauge") -> int:
        """Flat ``{name: number}`` ingest (per-push fleet summary
        scalars land through here on every tel_push)."""
        entries = [(name, labels, kind, _scalar(v), None)
                   for name, v in values.items()
                   if isinstance(v, (int, float))
                   and math.isfinite(float(v))]
        return self.append(t, entries)

    # -- seal / compaction / retention ---------------------------------
    def _downsample_records(self, payloads, bucket_s: float):
        """Re-bucket committed record payloads to last-sample-per-
        bucket-per-series; yields (meta, [(bucket_t, {key: enc})])."""
        meta: dict[str, dict] = {}
        per_bucket: dict[float, dict] = {}
        for payload in payloads:
            try:
                rec = json.loads(payload)
            except ValueError:
                continue
            for key, m in (rec.get("m") or {}).items():
                meta.setdefault(key, m)
            t = float(rec.get("t") or 0.0)
            b = int(t // bucket_s) * bucket_s
            slot = per_bucket.setdefault(b, {"t": t, "s": {}})
            if t >= slot["t"]:
                slot["t"] = t
                slot["s"].update(rec.get("s") or {})
            else:
                for key, enc in (rec.get("s") or {}).items():
                    slot["s"].setdefault(key, enc)
        # a series may predate this file: pull meta from memory so a
        # sealed block always replays standalone
        for b in per_bucket.values():
            for key in b["s"]:
                if key not in meta and key in self._series:
                    meta[key] = self._meta_locked(self._series[key])
        return meta, [(b, per_bucket[b]) for b in sorted(per_bucket)]

    def _write_block_locked(self, fname: str, meta: dict,
                            buckets) -> int:
        tmp = os.path.join(self.dir, fname + ".tmp")
        final = os.path.join(self.dir, fname)
        buf = bytearray()
        first = True
        for _, slot in buckets:
            rec = {"t": slot["t"], "s": slot["s"]}
            if first and meta:
                rec["m"] = meta
                first = False
            buf += _encode_record(rec)
        with open(tmp, "wb") as f:
            f.write(bytes(buf))
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        self._block_sizes[fname] = len(buf)
        return len(buf)

    def _seal_locked(self):
        active = os.path.join(self.dir, "active.tsb")
        try:
            with open(active, "rb") as f:
                blob = f.read()
        except OSError:
            return
        payloads = [p for p, _ in committed_records(blob)]
        if payloads:
            meta, buckets = self._downsample_records(payloads, 10.0)
            self._write_block_locked(f"block-{self._seq:06d}.tsb",
                                     meta, buckets)
            self._seq += 1
            self.counts["sealed"] += 1
            _SEALED.inc()
        os.close(self._fd)
        self._fd = os.open(active,
                           os.O_WRONLY | os.O_CREAT | os.O_TRUNC
                           | os.O_APPEND, 0o644)
        self._active_bytes = 0
        self._meta_written.clear()

    def _disk_bytes_locked(self) -> int:
        return self._active_bytes + sum(self._block_sizes.values())

    def _enforce_retention_locked(self):
        # degrade before deleting: oldest raw block -> 5m compaction;
        # an already-compacted oldest block is dropped outright
        while self._disk_bytes_locked() > self.retention_bytes:
            blocks = self._blocks_locked()
            if not blocks:
                return
            seq, compacted, fn = blocks[0]
            path = os.path.join(self.dir, fn)
            if not compacted:
                try:
                    with open(path, "rb") as f:
                        blob = f.read()
                except OSError:
                    blob = b""
                payloads = [p for p, _ in committed_records(blob)]
                meta, buckets = self._downsample_records(payloads,
                                                         300.0)
                self._write_block_locked(f"block-{seq:06d}c.tsb",
                                         meta, buckets)
                self.counts["compacted"] += 1
                _COMPACTED.inc()
            try:
                os.unlink(path)
            except OSError:
                pass
            self._block_sizes.pop(fn, None)
            if compacted:
                self.counts["deleted"] += 1
                _DELETED.inc()

    def _publish_gauges_locked(self):
        _SERIES.set(len(self._series))
        if self.dir:
            _DISK.set(self._disk_bytes_locked())

    # -- queries -------------------------------------------------------
    def _match_locked(self, name: str,
                      labels: dict | None) -> list[_Series]:
        out = []
        for s in self._series.values():
            if s.name != name:
                continue
            ok = True
            for k, want in (labels or {}).items():
                have = s.labels.get(k)
                if isinstance(want, (list, tuple, set, frozenset)):
                    ok = have in {str(w) for w in want}
                else:
                    ok = have == str(want)
                if not ok:
                    break
            if ok:
                out.append(s)
        return out

    def series(self, name: str | None = None) -> list[dict]:
        with self._lock:
            return [{"key": s.key, "name": s.name,
                     "labels": dict(s.labels), "kind": s.kind,
                     "last_t": s.last_t}
                    for s in self._series.values()
                    if name is None or s.name == name
                    or s.name.startswith(name)]

    def range(self, name: str, labels: dict | None = None,
              start: float | None = None,
              end: float | None = None) -> list[dict]:
        """Per matching series: time-ordered points. Histogram points
        surface as their sample count (sparkline-friendly); use
        ``quantile()`` for the distribution itself."""
        lo = -math.inf if start is None else float(start)
        hi = math.inf if end is None else float(end)
        with self._lock:
            out = []
            for s in self._match_locked(name, labels):
                pts = [(t, v[2] if isinstance(v, tuple) else v)
                       for t, v in s.points(lo, hi)]
                out.append({"key": s.key, "labels": dict(s.labels),
                            "kind": s.kind, "points": pts})
            return out

    def latest(self, name: str, labels: dict | None = None) -> float:
        """Sum of each matching series' latest value."""
        with self._lock:
            tot = 0.0
            for s in self._match_locked(name, labels):
                pts = s.points(-math.inf, math.inf)
                if pts:
                    v = pts[-1][1]
                    tot += v[2] if isinstance(v, tuple) else v
            return tot

    def latest_by(self, name: str, group_by,
                  labels: dict | None = None) -> dict:
        """Latest values summed per distinct group-label tuple."""
        group_by = list(group_by)
        with self._lock:
            out: dict[tuple, float] = {}
            for s in self._match_locked(name, labels):
                pts = s.points(-math.inf, math.inf)
                if not pts:
                    continue
                v = pts[-1][1]
                v = v[2] if isinstance(v, tuple) else v
                g = tuple(s.labels.get(k, "") for k in group_by)
                out[g] = out.get(g, 0.0) + v
            return out

    def _series_delta_locked(self, s: _Series, start: float,
                             end: float):
        """Window delta for one series. The value at the window start
        is the last sample at or before it; a series born inside the
        window counts from zero (its counter started there)."""
        pts = s.points(-math.inf, end)
        if not pts:
            return None
        v_end = pts[-1][1]
        v_start = s.value_at(start)
        if v_start is None:
            if isinstance(v_end, tuple):
                v_start = (tuple(0.0 for _ in v_end[0]), 0.0, 0.0)
            else:
                v_start = 0.0
        if isinstance(v_end, tuple):
            cum = tuple(max(0.0, a - b) for a, b in
                        zip(v_end[0], v_start[0])) \
                if len(v_end[0]) == len(v_start[0]) else v_end[0]
            return (cum, max(0.0, v_end[1] - v_start[1]),
                    max(0.0, v_end[2] - v_start[2]))
        return max(0.0, v_end - v_start)

    def delta(self, name: str, window: float,
              labels: dict | None = None,
              at: float | None = None) -> float:
        """Summed counter increase over the trailing window."""
        end = float(at) if at is not None else self._default_at(name)
        start = end - float(window)
        with self._lock:
            tot = 0.0
            for s in self._match_locked(name, labels):
                d = self._series_delta_locked(s, start, end)
                if d is None:
                    continue
                tot += d[2] if isinstance(d, tuple) else d
            return tot

    def delta_by(self, name: str, window: float, group_by,
                 labels: dict | None = None,
                 at: float | None = None) -> dict:
        """Window deltas summed per distinct group-label tuple (the
        per-tenant burn-rate feed)."""
        end = float(at) if at is not None else self._default_at(name)
        start = end - float(window)
        group_by = list(group_by)
        with self._lock:
            out: dict[tuple, float] = {}
            for s in self._match_locked(name, labels):
                d = self._series_delta_locked(s, start, end)
                if d is None:
                    continue
                v = d[2] if isinstance(d, tuple) else d
                g = tuple(s.labels.get(k, "") for k in group_by)
                out[g] = out.get(g, 0.0) + v
            return out

    def rate(self, name: str, window: float,
             labels: dict | None = None,
             at: float | None = None) -> float:
        """Per-second counter rate over the trailing window."""
        return self.delta(name, window, labels, at) \
            / max(1e-9, float(window))

    def quantile(self, name: str, q: float, window: float,
                 labels: dict | None = None,
                 at: float | None = None) -> float | None:
        """Histogram quantile over the trailing window: elementwise
        bucket-count delta across matching series, then the nearest-
        bucket estimate."""
        end = float(at) if at is not None else self._default_at(name)
        start = end - float(window)
        with self._lock:
            buckets = None
            cum = None
            for s in self._match_locked(name, labels):
                if s.kind != "histogram" or not s.buckets:
                    continue
                d = self._series_delta_locked(s, start, end)
                if not isinstance(d, tuple):
                    continue
                if buckets is None:
                    buckets = s.buckets
                    cum = list(d[0])
                elif len(d[0]) == len(cum):
                    cum = [a + b for a, b in zip(cum, d[0])]
            if cum is None:
                return None
            return hist_quantile(buckets, cum, float(q))

    def _default_at(self, name: str) -> float:
        """Default query anchor: the newest sample time of the metric
        (wall clocks of pushers, not the collector's own) — so replay
        and tests are deterministic. Takes the lock itself; callers
        invoke it before entering theirs."""
        with self._lock:
            return max((s.last_t or 0.0
                        for s in self._series.values()
                        if s.name == name), default=0.0)

    # -- admin ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {"series": len(self._series),
                    "dir": self.dir,
                    "bytes_on_disk": self._disk_bytes_locked()
                    if self.dir else 0,
                    "active_bytes": self._active_bytes,
                    "blocks": sorted(self._block_sizes),
                    "retention_bytes": self.retention_bytes,
                    "block_bytes": self.block_bytes,
                    "counts": dict(self.counts)}

    def close(self):
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
