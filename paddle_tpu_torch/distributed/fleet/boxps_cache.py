"""BoxPS-style hot-row sparse cache (counterpart of
``paddle_tpu/distributed/fleet/boxps_cache.py``; reference
paddle/fluid/framework/fleet/box_wrapper.h:1).

The reference's BoxPS keeps the hottest embedding rows resident in GPU
memory in front of the external PS, serving pulls device-side and
exchanging only aggregated deltas with the PS. Here, as in the JAX
package, the worker keeps a hot-vocab cache in host numpy next to its
loop, applies its own updates locally for read-your-writes semantics,
accumulates the deltas, and flushes the aggregate to the PS every
`flush_every` batches — the same traffic shape as BoxPS's
BeginPass/EndPass pull-push cycle.

`BoxPSWrapper` exposes the FleetWrapper sparse/dense surface, so
`DownpourWorker(BoxPSWrapper(fw), ...)` upgrades any PS job to the
cached path without touching the trainer.
"""
from __future__ import annotations

import numpy as np

from .runtime.rpc import PSRemoteError

__all__ = ["BoxPSWrapper"]


class _TableCache:
    """Vectorised hot-row store: a direct-index id->slot map (ids below
    `id_space`) over preallocated row/delta arrays — python-loop-free on
    the 100k-ids-per-batch CTR path."""

    def __init__(self, dim: int, capacity: int, id_space: int):
        self.dim = dim
        self.capacity = capacity
        self.id_space = id_space
        self.slot_of = np.full(id_space, -1, np.int32)
        self.ids = np.zeros(capacity, np.int64)
        self.data = np.zeros((capacity, dim), np.float32)
        self.delta = np.zeros((capacity, dim), np.float32)
        self.dirty = np.zeros(capacity, bool)   # slots touched since flush
        self.stale = np.zeros(capacity, bool)   # invalidated by the PS
        self.n = 0

    def ensure(self, kv_pull, uids: np.ndarray):
        """Admit missing (in-space) ids up to capacity with one PS pull."""
        uids = uids[uids < self.id_space]
        missing = uids[self.slot_of[uids] < 0]
        room = self.capacity - self.n
        missing = missing[:max(room, 0)]
        if len(missing):
            rows = kv_pull(missing)
            idx = np.arange(self.n, self.n + len(missing), dtype=np.int32)
            self.slot_of[missing] = idx
            self.ids[idx] = missing
            self.data[idx] = rows
            self.n += len(missing)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        idx = np.full(len(ids), -1, np.int32)
        ok = ids < self.id_space
        idx[ok] = self.slot_of[ids[ok]]
        return idx

    def invalidate(self, keys: np.ndarray | None = None):
        """Mark cached rows stale (keys=None: the whole table). Safe to
        call from the PS subscription thread concurrently with pulls:
        it only SETS per-slot flags — the worst interleaving refreshes
        a row one pull later, never serves it as fresh."""
        if keys is None:
            self.stale[:self.n] = True
            return
        keys = np.asarray(keys, np.int64).ravel()
        keys = keys[keys < self.id_space]
        slots = self.slot_of[keys]
        self.stale[slots[slots >= 0]] = True

    def refresh_stale(self, kv_pull) -> int:
        """Re-pull every stale row; re-apply the locally-buffered
        (unflushed) delta on top so read-your-writes holds: the local
        view is authoritative-PS-value minus the pending delta."""
        sl = np.flatnonzero(self.stale[:self.n])
        if not len(sl):
            return 0
        fresh = kv_pull(self.ids[sl])
        self.data[sl] = fresh - self.delta[sl]
        self.stale[sl] = False
        return len(sl)


class BoxPSWrapper:
    """FleetWrapper facade with a hot-row cache on the sparse tables."""

    def __init__(self, fleet_wrapper, capacity: int = 1 << 20,
                 flush_every: int = 8, id_space: int = 1 << 22):
        self.fw = fleet_wrapper
        self.capacity = capacity
        self.flush_every = flush_every
        self.id_space = id_space
        self._tables: dict[str, _TableCache] = {}
        self._batches = 0
        self._first_table = None
        self.cache_hits = 0
        self.cache_misses = 0
        self.stale_refreshes = 0   # rows re-pulled after invalidation
        self._inval_stop = None

    def _table(self, name: str, dim: int) -> _TableCache:
        t = self._tables.get(name)
        if t is None:
            t = self._tables[name] = _TableCache(dim, self.capacity,
                                                 self.id_space)
        return t

    # -- sparse (cached) ------------------------------------------------
    def pull_sparse(self, table: str, ids, dim: int,
                    init_std: float = 0.01) -> np.ndarray:
        ids = np.asarray(ids, np.int64).ravel()
        t = self._table(table, dim)
        # batch accounting: a new batch starts when the FIRST-registered
        # table is pulled again (DownpourWorker pulls every table once
        # per batch); the flush runs at batch boundaries so flush_every
        # counts BATCHES, not push calls
        if self._first_table is None:
            self._first_table = table
        if table == self._first_table:
            self._batches += 1
            if self._batches > 1 and (self._batches - 1) \
                    % self.flush_every == 0:
                self.flush()
        t.ensure(lambda m: self.fw.pull_sparse(table, m, dim,
                                               init_std=init_std),
                 np.unique(ids))
        # PS-pushed invalidations (other workers' flushed updates) land
        # as stale flags; refresh them before serving from the cache
        self.stale_refreshes += t.refresh_stale(
            lambda m: self.fw.pull_sparse(table, m, dim,
                                          init_std=init_std))
        idx = t.lookup(ids)
        hit = idx >= 0
        self.cache_hits += int(hit.sum())
        self.cache_misses += int((~hit).sum())
        out = np.empty((len(ids), dim), np.float32)
        out[hit] = t.data[idx[hit]]
        if (~hit).any():  # over-capacity ids pass through uncached
            out[~hit] = self.fw.pull_sparse(table, ids[~hit], dim,
                                            init_std=init_std)
        return out

    def push_sparse(self, table: str, ids, grads, dim: int,
                    lr: float = 1.0, init_std: float = 0.01):
        ids = np.asarray(ids, np.int64).ravel()
        grads = np.asarray(grads, np.float32).reshape(len(ids), dim)
        t = self._table(table, dim)
        idx = t.lookup(ids)
        hit = idx >= 0
        if hit.any():
            # local apply (read-your-writes) + delta accumulation for
            # the periodic PS flush — BoxPS device-side update semantics.
            # delta carries the lr-scaled update so the flush is lr-free
            # (pushes with mixed lrs accumulate correctly)
            np.add.at(t.data, idx[hit], -lr * grads[hit])
            np.add.at(t.delta, idx[hit], lr * grads[hit])
            t.dirty[idx[hit]] = True
        if (~hit).any():
            self.fw.push_sparse(table, ids[~hit], grads[~hit], dim,
                                lr=lr, init_std=init_std)

    def flush(self, refresh: bool = True):
        """Push accumulated deltas, then (BoxPS EndPass) re-pull the
        dirty rows so the cache picks up other workers' merged updates.
        Only the per-interval aggregate crosses the wire — 1/flush_every
        of the uncached pull+push traffic.

        Fault tolerance: a table whose push fails past the transport's
        retry deadline KEEPS its delta/dirty state so the update is not
        silently lost (the next flush re-sends it; within a single push
        the transport's request-id dedup keeps retries exactly-once —
        only a deadline-exceeded push abandoned mid-fanout can
        double-apply on shards that already committed), and the
        remaining tables still
        flush; the first error re-raises at the end so the caller sees
        the degraded shard."""
        first_err: Exception | None = None
        for name, t in self._tables.items():
            dirty = np.flatnonzero(t.dirty[:t.n])
            if not len(dirty):
                continue
            try:
                self.fw.push_sparse(name, t.ids[dirty], t.delta[dirty],
                                    t.dim, lr=1.0)
            except (ConnectionError, OSError, PSRemoteError) as e:
                # transport outage OR a server-side dispatch error on
                # this table: either way the other tables still flush
                first_err = first_err or e
                continue
            t.delta[dirty] = 0.0
            t.dirty[dirty] = False
            if refresh:
                try:
                    t.data[dirty] = self.fw.pull_sparse(
                        name, t.ids[dirty], t.dim)
                except (ConnectionError, OSError, PSRemoteError) as e:
                    # push landed; only the EndPass refresh failed —
                    # the rows stay locally-consistent (stale vs other
                    # workers until the next successful refresh) and
                    # the remaining tables still flush
                    first_err = first_err or e
        if first_err is not None:
            raise first_err

    # -- PS-pushed invalidation wiring ----------------------------------
    def invalidate(self, table: str, keys=None):
        """Invalidation callback: mark cached rows of ``table`` stale
        (keys=None invalidates the whole table). Shaped to plug
        straight into PSClient.subscribe_invalidations."""
        t = self._tables.get(table)
        if t is not None:
            t.invalidate(keys)

    def attach_invalidations(self, ps_client=None) -> bool:
        """Subscribe this cache to the PS shards' push-invalidation
        stream, so other workers' flushed updates stop being served
        stale between this worker's own flushes. Defaults to the
        wrapped FleetWrapper's own PSClient; returns False when there
        is none (local mode)."""
        if ps_client is None:
            ps_client = getattr(self.fw, "_client", None)
        if ps_client is None:
            return False
        self._inval_stop = ps_client.subscribe_invalidations(
            self.invalidate)
        return True

    def detach_invalidations(self):
        if self._inval_stop is not None:
            self._inval_stop.set()
            self._inval_stop = None

    # -- dense + misc pass-through --------------------------------------
    def pull_dense(self, name, shape):
        return self.fw.pull_dense(name, shape)

    def push_dense(self, name, grad, lr: float = 1.0):
        return self.fw.push_dense(name, grad, lr=lr)

    def __getattr__(self, item):
        return getattr(self.fw, item)
