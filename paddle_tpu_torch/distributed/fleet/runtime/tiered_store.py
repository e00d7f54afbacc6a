"""Tiered embedding parameter store: hot/warm/cold row hierarchy with
demand paging from the content-addressed chunk store (counterpart of
``paddle_tpu/distributed/fleet/runtime/tiered_store.py``: the same
tiering rules, metric names and ``PADDLE_PS_TIER_*`` knobs, and the
same exported state after the same interleaving of pulls, pushes and
demotions).

Production recommenders hold 10^9+ embedding rows — far beyond one
host's RAM (reference: the Paddle fleet/heter-PS hierarchy). This
module gives :class:`~.parameter_server_runtime.PSServer` a per-table
opt-in replacement for ``LargeScaleKV`` that keeps only the frequently
accessed rows resident:

  hot   worker-side rows in the ``boxps_cache`` hot-row cache
        (client tier — unchanged by this module; server pushes
        invalidations exactly as before)
  warm  rows in host RAM on the shard, inside the byte budget
        (``PADDLE_PS_TIER_WARM_BYTES``)
  cold  rows demand-paged from a local ``CheckpointStore`` chunk store
        via its ``read_rows`` row-range reads

Admission/eviction is frequency-based: every access bumps a per-slot
counter (exponentially decayed each demotion pass), and a background
demoter evicts the coldest rows once warm residency crosses the
budget, down to a low watermark. Rows with an up-to-date cold copy
(faulted in, never pushed since) are *reverted* for free; dirty rows
are flushed as an immutable row segment whose chunks go through
``ChunkStore.put`` — written entirely OFF the table lock and the
server's apply lock, then committed row-by-row so rows touched during
the write simply stay warm.

Bit-exactness contract (the WAL/HA parity property): faulting a row in
or demoting it never changes its value and never touches the table's
init RNG stream; only creating a genuinely new row draws from the RNG,
through the identical batched-draw path ``LargeScaleKV._ensure`` uses.
``apply_rows`` (WAL replay / HA replication apply) admits cold keys
directly with the journaled post-values — the original apply saw an
existing row, so replay must not draw either. ``export_state``
materializes cold rows back into the flat keys/rows arrays, so
snapshots, HA bootstraps, and parity checks see exactly the state an
all-warm table would hold.

Failure containment: a failing cold read (chunk missing/corrupt, or an
injected ``PADDLE_PS_FAULT_COLD_ACTION=error``) raises
:class:`ColdReadError` — the server turns it into an error reply for
THAT pull only; nothing is admitted, evicted, or wedged, and the
retried pull re-faults cleanly. A failing segment *write* leaves the
victims warm (budget temporarily exceeded) and is retried next pass.
"""
from __future__ import annotations

import os
import threading
import time
import weakref

import numpy as np

from ....observability import registry as _obs
from .fault_injection import injector
from .parameter_server_runtime import LargeScaleKV

__all__ = ["TieredTable", "ColdReadError", "gc_cold_store"]

# -- tier telemetry (single registration site; the invariants rule's
# REQUIRED set and the collector/top tier pane read these exact names)
_HITS = _obs.counter(
    "paddle_tpu_ps_tier_hits_total",
    "rows served by tier: warm = resident RAM, cold = demand-paged "
    "from the chunk store (hot-tier hits live on the worker cache)",
    ["tier"])
_MISSES = _obs.counter(
    "paddle_tpu_ps_tier_misses_total",
    "rows resident in NO tier at access time (lazy-init creations)")
_FAULTS = _obs.counter(
    "paddle_tpu_ps_tier_faults_total",
    "cold rows faulted into the warm tier")
_DEMOTIONS = _obs.counter(
    "paddle_tpu_ps_tier_demotions_total",
    "rows demoted warm->cold: clean = cold copy still valid (free), "
    "flush = dirty rows written as a fresh segment", ["kind"])
_COLD_ERRORS = _obs.counter(
    "paddle_tpu_ps_tier_cold_read_errors_total",
    "failed cold-tier reads (chunk missing/corrupt or injected) — "
    "each fails only its own pull")
_PULL_SECONDS = _obs.histogram(
    "paddle_tpu_ps_tier_pull_seconds",
    "table-level pull latency by serving tier (cold = the pull "
    "demand-paged at least one row)", ["tier"],
    buckets=(1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
             5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 1.0))
_RES_ROWS = _obs.gauge(
    "paddle_tpu_ps_tier_resident_rows",
    "rows resident per tier across this process's tiered tables",
    ["tier"])
_RES_BYTES = _obs.gauge(
    "paddle_tpu_ps_tier_resident_bytes",
    "row payload bytes resident per tier across this process's "
    "tiered tables", ["tier"])

# live tables for the exposition-time resident gauges (evaluated
# outside the series lock; len() reads need no table lock)
_TABLES: "weakref.WeakSet[TieredTable]" = weakref.WeakSet()


def _sum_tables(fn) -> float:
    return float(sum(fn(t) for t in list(_TABLES)))


_RES_ROWS.labels(tier="warm").set_function(
    lambda: _sum_tables(lambda t: len(t._index)))
_RES_ROWS.labels(tier="cold").set_function(
    lambda: _sum_tables(lambda t: len(t._cold)))
_RES_BYTES.labels(tier="warm").set_function(
    lambda: _sum_tables(lambda t: len(t._index) * t.row_bytes))
_RES_BYTES.labels(tier="cold").set_function(
    lambda: _sum_tables(lambda t: len(t._cold) * t.row_bytes))


class ColdReadError(RuntimeError):
    """A cold-tier read failed (chunk missing/corrupt or injected).
    Contained to the one pull that needed the row — the server answers
    that request with an error frame and stays healthy."""


def _demote_loop(ref, stop: threading.Event, interval: float):
    """Background demoter body: module-level + weakref so an abandoned
    table is collectable (the thread exits when the ref dies)."""
    while not stop.wait(interval):
        t = ref()
        if t is None:
            return
        try:
            t.demote()
        except Exception:
            pass  # never kill the demoter; next pass retries
        del t


class TieredTable(LargeScaleKV):
    """``LargeScaleKV`` with a byte-budgeted warm tier and a cold tier
    demand-paged from a chunk store. Numpy-only: tier bookkeeping
    lives in per-slot arrays parallel to the row arena, so the native
    core is bypassed even when built.

    ``store`` is a ``checkpoint.store.CheckpointStore``
    (its ``chunks`` + ``read_rows`` are the only parts used; no
    manifests are ever committed). Segments are hand-built manifest
    ``arrays`` entries kept in memory — crash recovery of the cold
    tier is NOT this table's job: the WAL/snapshot tier already
    journals every row, and ``export_state`` rematerializes cold rows,
    so a restart rebuilds from base+journal and re-demotes.
    """

    def __init__(self, dim: int, init_std: float = 0.01, seed: int = 0,
                 *, store, name: str = "", warm_bytes: int = 0,
                 low_frac: float = 0.8, demote_interval: float = 0.0):
        super().__init__(dim, init_std=init_std, seed=seed)
        self._native = None  # tier bookkeeping needs the numpy arena
        self._store = store
        self.name = name
        self.row_bytes = int(dim) * 4  # float32 rows
        self.warm_bytes = int(warm_bytes)
        self.low_frac = float(low_frac)
        # per-slot bookkeeping, parallel to the _data arena
        self._slot_key = np.empty(0, np.int64)    # -1 = free slot
        self._freq = np.zeros(0, np.float64)      # decayed access count
        self._stamp = np.zeros(0, np.int64)       # last-touch tick
        self._clean_seg = np.empty(0, np.int64)   # valid cold copy seg
        self._clean_row = np.zeros(0, np.int64)   # ... and its row
        self._top = 0                             # arena high-water
        self._free: list[int] = []
        self._tick = 0
        # cold tier: key -> (seg, row); seg -> {"ent", "live", "total"}
        self._cold: dict[int, tuple[int, int]] = {}
        self._segs: dict[int, dict] = {}
        self._next_seg = 0
        self._export_pins = 0  # in-flight exports pin chunks vs GC
        # keys of the accesses now faulting rows in, each with the
        # number of such accesses: demotion spares their rows (_pin)
        self._pinned: dict[int, int] = {}
        # per-table stats (bench/tests; the registry carries the
        # process-wide aggregates)
        self.warm_hits = 0
        self.cold_faults = 0
        self.creates = 0
        self.demoted_clean = 0
        self.demoted_flush = 0
        self.cold_read_errors = 0
        _TABLES.add(self)
        self._demote_stop = threading.Event()
        if demote_interval > 0:
            threading.Thread(
                target=_demote_loop,
                args=(weakref.ref(self), self._demote_stop,
                      float(demote_interval)),
                daemon=True, name=f"ps-tier-demote-{name}").start()
        weakref.finalize(self, self._demote_stop.set)

    def close(self):
        """Stop the background demoter (PSServer.server_close)."""
        self._demote_stop.set()

    # -- slot allocation (free-list: eviction punches holes the base
    # class's dense start=len(index) allocator cannot reuse) ------------
    def _alloc_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if self._top >= len(self._data):
            cap = max(self._top + 1, 2 * len(self._data) + 64)
            self._data = self._grown(self._data, cap)
            self._slot_key = self._grown(self._slot_key, cap, -1)
            self._freq = self._grown(self._freq, cap, 0)
            self._stamp = self._grown(self._stamp, cap, 0)
            self._clean_seg = self._grown(self._clean_seg, cap, -1)
            self._clean_row = self._grown(self._clean_row, cap, 0)
        s = self._top
        self._top += 1
        return s

    @staticmethod
    def _grown(a: np.ndarray, cap: int, fill=None) -> np.ndarray:
        shape = (cap,) + a.shape[1:]
        out = np.empty(shape, a.dtype) if fill is None \
            else np.full(shape, fill, a.dtype)
        out[:len(a)] = a
        return out

    def _ensure(self, keys: np.ndarray) -> np.ndarray:
        """Base-class contract (create truly-missing rows), free-list
        slots. The RNG draw is bit-identical to the base: ONE batched
        normal over the deduped missing keys in first-occurrence order
        — callers must have faulted/admitted every cold key first, or
        a cold row would be shadowed by a fresh draw."""
        idx = self._index
        missing = list(dict.fromkeys(
            k for k in keys.tolist() if k not in idx))
        if missing:
            fresh = self._rng.normal(
                0, self.init_std,
                (len(missing), self.dim)).astype(np.float32)
            for i, k in enumerate(missing):
                s = self._alloc_slot()
                self._data[s] = fresh[i]
                idx[k] = s
                self._slot_key[s] = k
                self._freq[s] = 0.0
                self._stamp[s] = self._tick
                self._clean_seg[s] = -1
            self.creates += len(missing)
            _MISSES.inc(len(missing))
        return np.fromiter((idx[k] for k in keys.tolist()), np.int64,
                           len(keys))

    def _seg_unref(self, seg: int):
        e = self._segs.get(seg)
        if e is not None:
            e["live"] -= 1
            if e["live"] <= 0:
                del self._segs[seg]  # chunks die at the next GC pass

    def _dirty_slots(self, slots: np.ndarray):
        """A write landed on these slots: any clean cold copy is stale
        now, so the WAL journal hook's rows_for sees post-values and a
        later demotion must flush, not revert."""
        for s in set(slots.tolist()):
            seg = int(self._clean_seg[s])
            if seg >= 0:
                self._clean_seg[s] = -1
                self._seg_unref(seg)

    def _cold_among(self, ks: list[int]) -> list[int]:
        return [k for k in dict.fromkeys(ks)
                if k not in self._index and k in self._cold]

    def _pin(self, pin, ks: list[int]):
        """An access found cold rows and must fault them in (caller
        holds the lock). Pin its keys on the first call, so no demotion
        pass evicts a row of this access until it completes; rows of
        other accesses stay fair game. Without the pin, an access wider
        than the low watermark re-faults its rows for as long as the
        demoter keeps evicting them between its fault-in and its
        re-check. A pin changes no value, stamp or count, so a run
        without concurrent demotion ends in the reference's state.
        Returns the pin (the access's keys)."""
        if pin is None:
            pin = list(dict.fromkeys(ks))
            for k in pin:
                self._pinned[k] = self._pinned.get(k, 0) + 1
        return pin

    def _unpin(self, pin):
        if pin is not None:
            with self._lock:
                for k in pin:
                    n = self._pinned.pop(k) - 1
                    if n:
                        self._pinned[k] = n

    # -- cold-tier IO (always OUTSIDE self._lock) ------------------------
    def _read_refs(self, refs: dict[int, tuple[int, int]],
                   ents: dict[int, dict]) -> dict[int, np.ndarray]:
        """Read the rows behind ``refs`` (key -> (seg, row)) from the
        store, coalescing adjacent rows per segment into range reads.
        Raises ColdReadError on any failed chunk read."""
        by_seg: dict[int, list[tuple[int, int]]] = {}
        for k, (seg, row) in refs.items():
            by_seg.setdefault(seg, []).append((row, k))
        got: dict[int, np.ndarray] = {}
        for seg, pairs in by_seg.items():
            pairs.sort()
            i = 0
            while i < len(pairs):
                j = i
                while j + 1 < len(pairs) \
                        and pairs[j + 1][0] == pairs[j][0] + 1:
                    j += 1
                lo, hi = pairs[i][0], pairs[j][0] + 1
                try:
                    block = self._store.read_rows(ents[seg], lo, hi)
                except Exception as e:
                    self.cold_read_errors += 1
                    _COLD_ERRORS.inc()
                    raise ColdReadError(
                        f"cold_read_failed table={self.name!r} "
                        f"seg={seg} rows=[{lo},{hi}): {e}") from e
                for p in range(i, j + 1):
                    got[pairs[p][1]] = block[pairs[p][0] - lo]
                i = j + 1
        return got

    def _fault_in(self, cold_keys: list[int]) -> int:
        """Demand-page ``cold_keys`` into the warm tier. The chunk
        reads run outside the table lock; admission re-checks each ref
        so a raced eviction/re-admission is skipped, never clobbered.
        Missing keys raise KeyError (rows_for contract)."""
        inj = injector()
        if inj.active:
            act = inj.cold_fault(self.name, cold_keys)
            if act is not None:
                action, delay = act
                if action == "error":
                    self.cold_read_errors += 1
                    _COLD_ERRORS.inc()
                    raise ColdReadError(
                        f"cold_read_failed (injected) "
                        f"table={self.name!r}")
                if action == "delay":
                    time.sleep(delay)
        with self._lock:
            refs = {}
            for k in cold_keys:
                r = self._cold.get(k)
                if r is not None:
                    refs[k] = r
                elif k not in self._index:
                    raise KeyError(k)
            ents = {seg: self._segs[seg]["ent"]
                    for seg in {r[0] for r in refs.values()}}
        got = self._read_refs(refs, ents)
        with self._lock:
            self._tick += 1
            n = 0
            for k, v in got.items():
                if self._cold.get(k) != refs[k]:
                    continue  # raced with another fault/GC decision
                del self._cold[k]
                s = self._alloc_slot()
                self._index[k] = s
                self._slot_key[s] = k
                self._data[s] = v
                self._freq[s] = 1.0
                self._stamp[s] = self._tick
                seg, row = refs[k]
                # cold ref becomes a clean ref: seg live is unchanged
                self._clean_seg[s] = seg
                self._clean_row[s] = row
                n += 1
            self.cold_faults += n
        _FAULTS.inc(n)
        _HITS.labels(tier="cold").inc(n)
        return n

    # -- table surface ---------------------------------------------------
    def pull_ex(self, keys) -> tuple[np.ndarray, int]:
        """Pull plus the number of rows demand-paged (the server wraps
        a faulting reply so PSClient can count cold faults)."""
        t0 = time.perf_counter()
        ks = np.asarray(keys, np.int64).ravel()
        faults = 0
        pin = None
        try:
            while True:
                with self._lock:
                    self._tick += 1
                    cold = self._cold_among(ks.tolist())
                    if not cold:
                        nwarm = sum(1 for k in dict.fromkeys(ks.tolist())
                                    if k in self._index)
                        slots = self._ensure(ks)
                        self._freq[slots] += 1.0
                        self._stamp[slots] = self._tick
                        out = self._data[slots].copy()
                        break
                    pin = self._pin(pin, ks.tolist())
                faults += self._fault_in(cold)
        finally:
            self._unpin(pin)
        self.warm_hits += nwarm - faults if faults else nwarm
        _HITS.labels(tier="warm").inc(max(nwarm - faults, 0))
        _PULL_SECONDS.labels(
            tier="cold" if faults else "warm").observe(
            time.perf_counter() - t0)
        return out, faults

    def pull(self, keys) -> np.ndarray:
        return self.pull_ex(keys)[0]

    def push(self, keys, grads, lr: float = 1.0):
        """Fault-then-apply: cold rows are paged in first, so the
        apply (and the WAL journal hook's rows_for read) always sees
        warm rows — journaling stays touched-rows-only and standbys
        track tier transitions row-for-row."""
        ks = np.asarray(keys, np.int64).ravel()
        pin = None
        try:
            while True:
                with self._lock:
                    self._tick += 1
                    cold = self._cold_among(ks.tolist())
                    if not cold:
                        slots = self._ensure(ks)
                        np.add.at(self._data, slots,
                                  (-lr * np.asarray(grads))
                                  .astype(np.float32))
                        self._dirty_slots(slots)
                        self._freq[slots] += 1.0
                        self._stamp[slots] = self._tick
                        return
                    pin = self._pin(pin, ks.tolist())
                self._fault_in(cold)
        finally:
            self._unpin(pin)

    def rows_for(self, keys) -> np.ndarray:
        ks = np.asarray(keys, np.int64).ravel()
        pin = None
        try:
            while True:
                with self._lock:
                    cold = [k for k in dict.fromkeys(ks.tolist())
                            if k not in self._index]
                    if not cold:
                        slots = np.fromiter(
                            (self._index[int(k)] for k in ks.tolist()),
                            np.int64, len(ks))
                        return self._data[slots].copy()
                    pin = self._pin(pin, ks.tolist())
                self._fault_in(cold)  # KeyError for truly-missing keys
        finally:
            self._unpin(pin)

    def missing_keys(self, keys) -> np.ndarray:
        """Keys resident in NO tier (exactly what a pull would lazily
        create — cold rows are NOT missing, faulting consumes no RNG)."""
        with self._lock:
            idx, cold = self._index, self._cold
            return np.fromiter(
                dict.fromkeys(
                    k for k in np.asarray(keys, np.int64)
                    .ravel().tolist()
                    if k not in idx and k not in cold),
                np.int64)

    def apply_rows(self, keys, rows):
        """WAL replay / HA replication apply. Cold keys are admitted
        DIRECTLY with the journaled post-values — on the primary the
        row existed (no RNG draw), so replay reads no store and draws
        nothing; only truly-new keys go through _ensure's batched
        draw. Bit-exact against the original apply order."""
        with self._lock:
            self._tick += 1
            ks = np.asarray(keys, np.int64).ravel()
            vals = np.asarray(rows, np.float32).reshape(len(ks),
                                                        self.dim)
            for k in dict.fromkeys(ks.tolist()):
                ref = self._cold.get(k)
                if ref is None or k in self._index:
                    continue
                del self._cold[k]
                s = self._alloc_slot()
                self._index[k] = s
                self._slot_key[s] = k
                self._freq[s] = 1.0
                self._stamp[s] = self._tick
                self._clean_seg[s] = -1
                self._seg_unref(ref[0])  # journaled value supersedes
            slots = self._ensure(ks)
            self._data[slots] = vals
            self._dirty_slots(slots)
            self._stamp[slots] = self._tick

    def size(self) -> int:
        with self._lock:
            return len(self._index) + len(self._cold)

    def warm_resident_bytes(self) -> int:
        return len(self._index) * self.row_bytes

    def stats(self) -> dict:
        with self._lock:
            return {"warm_rows": len(self._index),
                    "cold_rows": len(self._cold),
                    "warm_bytes": len(self._index) * self.row_bytes,
                    "segments": len(self._segs),
                    "warm_hits": self.warm_hits,
                    "cold_faults": self.cold_faults,
                    "creates": self.creates,
                    "demoted_clean": self.demoted_clean,
                    "demoted_flush": self.demoted_flush,
                    "cold_read_errors": self.cold_read_errors}

    # -- demotion (watermark-driven, off the apply lock) -----------------
    def demote(self) -> int:
        """One demotion pass: when warm residency exceeds the budget,
        evict the lowest-frequency rows (oldest-stamp tie-break) down
        to the low watermark. Clean rows revert to their existing cold
        copy under the lock; dirty rows are flushed as a fresh segment
        whose chunk writes run with NO lock held, then committed
        row-by-row — a row touched during the write stays warm.
        Rows touched at the current tick, and the rows of an access
        still faulting in (``_pin``), are never victims (livelock
        guard: a faulting access always completes before its rows can
        be re-evicted). Returns rows demoted."""
        with self._lock:
            resident = len(self._index) * self.row_bytes
            if self.warm_bytes <= 0 or resident <= self.warm_bytes:
                return 0
            # open a new tick: rows stamped before it are fair game,
            # rows a concurrently-faulting pull admits land at the new
            # tick and survive until that pull has served them
            self._tick += 1
            cut = self._tick
            target = int(self.warm_bytes * self.low_frac)
            need = -(-(resident - target) // self.row_bytes)
            act = np.flatnonzero(self._slot_key[:self._top] >= 0)
            act = act[self._stamp[act] < cut]
            if self._pinned:
                # rows of an access still faulting in stay warm
                act = act[~np.isin(self._slot_key[act], np.fromiter(
                    self._pinned, np.int64, len(self._pinned)))]
            if not len(act):
                return 0
            order = np.lexsort((self._stamp[act], self._freq[act]))
            victims = act[order][:need]
            self._freq[:self._top] *= 0.5  # age the access counts
            clean = victims[self._clean_seg[victims] >= 0]
            for s in clean.tolist():
                k = int(self._slot_key[s])
                del self._index[k]
                self._cold[k] = (int(self._clean_seg[s]),
                                 int(self._clean_row[s]))
                self._slot_key[s] = -1
                self._clean_seg[s] = -1
                self._free.append(s)
            nclean = len(clean)
            self.demoted_clean += nclean
            dirty_slots = victims[self._clean_seg[victims] < 0]
            dirty = [(int(self._slot_key[s]), int(s),
                      int(self._stamp[s]))
                     for s in dirty_slots.tolist()]
            vals = self._data[dirty_slots].copy() if len(dirty_slots) \
                else None
        if nclean:
            _DEMOTIONS.labels(kind="clean").inc(nclean)
        if not dirty:
            return nclean
        # flush the dirty victims as one immutable segment — chunk
        # writes on the demoter thread only, no lock held
        blob = vals.tobytes()
        ent = {"dtype": np.dtype(np.float32).str,
               "shape": [len(dirty), self.dim],
               "nbytes": len(blob), "chunks": []}
        cb = int(getattr(self._store, "chunk_bytes", 1 << 20))
        try:
            for off in range(0, len(blob), cb):
                piece = blob[off:off + cb]
                ent["chunks"].append(
                    {"h": self._store.chunks.put(piece), "o": off,
                     "n": len(piece)})
        except Exception:
            # store write failed: victims stay warm (budget exceeded
            # until the next pass succeeds) — never wedge the shard
            self.cold_read_errors += 1
            _COLD_ERRORS.inc()
            return nclean
        with self._lock:
            seg = self._next_seg
            self._next_seg += 1
            live = 0
            for row, (k, s, st0) in enumerate(dirty):
                if self._index.get(k) != s \
                        or int(self._slot_key[s]) != k \
                        or int(self._stamp[s]) != st0 \
                        or self._clean_seg[s] >= 0 or k in self._pinned:
                    continue  # touched or pinned during the write
                del self._index[k]
                self._cold[k] = (seg, row)
                self._slot_key[s] = -1
                self._free.append(s)
                live += 1
            if live:
                self._segs[seg] = {"ent": ent, "live": live,
                                   "total": len(dirty)}
            self.demoted_flush += live
        if live:
            _DEMOTIONS.labels(kind="flush").inc(live)
        return nclean + live

    def drain(self, passes: int = 64) -> int:
        """Synchronously demote until under budget (tests/bench)."""
        n = 0
        for _ in range(passes):
            d = self.demote()
            n += d
            if not d:
                break
        return n

    # -- snapshot/HA export-import ---------------------------------------
    def export_state(self) -> dict:
        """Materialize the WHOLE table — warm rows plus cold rows read
        back from the store — into the flat keys/rows/rng dict every
        consumer of LargeScaleKV state understands. Point-in-time:
        warm rows are copied under the lock, cold segment bytes are
        immutable, and in-flight exports pin chunks against GC."""
        with self._lock:
            keys_w = np.fromiter(self._index, np.int64,
                                 len(self._index))
            slots = np.fromiter(self._index.values(), np.int64,
                                len(self._index))
            rows_w = self._data[slots].copy()
            rng = self._rng.get_state()
            cold = dict(self._cold)
            ents = {seg: self._segs[seg]["ent"]
                    for seg in {r[0] for r in cold.values()}}
            self._export_pins += 1
        try:
            got = self._read_refs(cold, ents) if cold else {}
        finally:
            with self._lock:
                self._export_pins -= 1
        if got:
            keys_c = np.fromiter(got, np.int64, len(got))
            rows_c = np.stack([got[int(k)] for k in keys_c])
            keys = np.concatenate([keys_w, keys_c])
            rows = np.concatenate([rows_w, rows_c]) if len(keys_w) \
                else rows_c
        else:
            keys, rows = keys_w, rows_w
        return {"dim": self.dim, "init_std": self.init_std,
                "seed": self.seed, "keys": keys, "rows": rows,
                "rng": {"alg": rng[0],
                        "key": np.asarray(rng[1], np.uint32),
                        "pos": int(rng[2]),
                        "has_gauss": int(rng[3]),
                        "cached": float(rng[4])}}

    def import_state(self, st: dict):
        """Restore from a flat export: everything lands WARM (the
        demoter re-demotes under the budget asynchronously); prior
        segments are dropped — their chunks age out via gc_cold_store."""
        with self._lock:
            self._tick += 1
            self.dim = int(st["dim"])
            self.init_std = float(st.get("init_std", self.init_std))
            self.seed = int(st.get("seed", self.seed))
            self.row_bytes = self.dim * 4
            keys = np.asarray(st["keys"], np.int64)
            rows = np.asarray(st["rows"], np.float32)
            n = len(keys)
            self._data = np.ascontiguousarray(
                rows.reshape(n, self.dim))
            self._index = {int(k): i for i, k in enumerate(keys)}
            self._slot_key = keys.copy()
            self._freq = np.zeros(n, np.float64)
            self._stamp = np.full(n, self._tick, np.int64)
            self._clean_seg = np.full(n, -1, np.int64)
            self._clean_row = np.zeros(n, np.int64)
            self._top = n
            self._free = []
            self._cold = {}
            self._segs = {}
            rng = st.get("rng")
            if rng is not None:
                self._rng.set_state((
                    str(rng["alg"]),
                    np.asarray(rng["key"], np.uint32),
                    int(rng["pos"]), int(rng["has_gauss"]),
                    float(rng["cached"])))


def gc_cold_store(store, tables, min_age: float = 60.0) -> int:
    """Drop cold-store chunks no live segment references. Age-guarded
    (mtime older than ``min_age`` seconds) so a segment being written
    concurrently — its chunks exist on disk before its table registers
    the ent — is never collected; in-flight exports skip the pass
    entirely. Runs after full base snapshots; never raises."""
    try:
        live: set[str] = set()
        for t in tables:
            if not isinstance(t, TieredTable) or t._store is not store:
                continue
            with t._lock:
                if t._export_pins:
                    return 0
                for e in t._segs.values():
                    for c in e["ent"]["chunks"]:
                        live.add(c["h"])
        n = 0
        now = time.time()
        for d in store.chunks.all_digests():
            if d in live:
                continue
            p = store.chunks._path(d)
            try:
                if now - os.path.getmtime(p) < min_age:
                    continue
                os.unlink(p)
                n += 1
            except OSError:
                continue
        return n
    except Exception:
        return 0
