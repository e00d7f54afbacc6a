"""Coordinated cluster checkpoints + world-resize resume (counterpart
of ``paddle_tpu/distributed/cluster_ckpt.py``, over the port's
``checkpoint/store.py`` part API: the same manifests, layout meta and
part names, so a cluster checkpoint written by either package restores
under the other's ``ClusterCheckpoint``).

The elastic-training substrate: every rank of a collective job
snapshots its share of (params, optimizer slots, RNG streams, data
cursor) through the content-addressed store's multi-host part API,
tagged with the SAME step id, and rank 0 merge-commits — one atomic
manifest per cluster version. A kill anywhere before the merge rename
leaves the previous version restorable bit-for-bit. Values may be numpy
arrays or ``torch.Tensor``s on any device (the store copies them to the
host); a bfloat16 tensor raises, as in the JAX package, so a trainer
saves its float32 master weights.

Layout kinds (recorded in the manifest meta, drive the resume path):

- ``replicated`` — identical on every rank (dp params, scalar step
  counters). Saved once by rank 0 under its plain name; restore
  broadcasts the full array to every new rank.
- ``sharded`` — axis-0 partitioned across ranks (np.array_split
  convention). Each rank publishes its piece as ``name@shardNNNN``;
  restore to ANY world size stitches the pieces and re-cuts them on
  the new partition, reading only the overlapping chunks.
- ``per_rank`` — private, world-shaped state (RNG counters). Saved as
  ``name@rankNNNN``; restored exactly only at the SAME world size,
  otherwise ``None`` — callers re-derive it counter-style from
  (seed, step), which is why ``SampleSchedule`` below exists.

Cadence: ``maybe_save(step, ...)`` fires on a step modulus
(``every_steps``, the coordinated default — all ranks agree with no
traffic) and/or a seconds budget: rank 0 publishes an *intent file*
one step ahead, every rank polls it at the next ``maybe_save`` and
joins the save at that agreed step. Async saves ride the store's one
persistent writer thread (host copies now, IO off the step path).

Resume ordering across a resize (``SampleSchedule``): the sample
permutation is counter-based Philox keyed by (seed, epoch) — any
(rank, world) can regenerate it without state, so after a W→W'
restart the REMAINING samples repartition deterministically and the
global batch composition per step is world-invariant. That is what
makes the resumed loss curve continue the fault-free run's.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..observability import flight as _flight, registry as _obs
from ..checkpoint import CheckpointStore
from ..checkpoint import manifest as _manifest

__all__ = ["ClusterCheckpoint", "SampleSchedule",
           "ClusterCheckpointError"]

_RESUME_SECONDS = _obs.histogram(
    "paddle_tpu_elastic_resume_seconds",
    "wall time of one cluster-checkpoint restore (resharding incl.)")

# domain-separation constant for the sample-order Philox key ("elas")
_SCHEDULE_TAG = 0x656C6173


class ClusterCheckpointError(RuntimeError):
    pass


def _env_opt_int(name: str) -> int | None:
    v = os.environ.get(name, "")
    return int(v) if v else None


def _env_opt_float(name: str) -> float | None:
    v = os.environ.get(name, "")
    return float(v) if v else None


class SampleSchedule:
    """Counter-based sample-order schedule keyed by (seed, epoch).

    The epoch permutation comes from a Philox generator whose key is
    (seed, epoch, tag) — no mutable RNG state survives a restart, so
    every rank of every world size regenerates the identical order.
    ``global_indices(step)`` is world-invariant; ``rank_indices``
    slices each rank's even share of the SAME global batch, so a
    resumed run at a different world consumes the remaining samples
    in the same global order with the same batch composition.
    """

    def __init__(self, seed: int, epoch: int, num_samples: int,
                 global_batch: int):
        if num_samples <= 0 or global_batch <= 0:
            raise ValueError("num_samples and global_batch must be "
                             "positive")
        if global_batch > num_samples:
            raise ValueError("global_batch larger than the epoch")
        self.seed, self.epoch = int(seed), int(epoch)
        self.num_samples = int(num_samples)
        self.global_batch = int(global_batch)
        self.steps_per_epoch = self.num_samples // self.global_batch
        mask = (1 << 64) - 1
        # 128-bit Philox key: seed word + (epoch, domain-tag) word
        key = np.array([self.seed & mask,
                        ((self.epoch & 0xFFFFFFFF) << 32)
                        | _SCHEDULE_TAG & mask], dtype=np.uint64)
        rng = np.random.Generator(np.random.Philox(key=key))
        self.perm = rng.permutation(self.num_samples)

    def global_indices(self, step: int) -> np.ndarray:
        """Sample ids of this epoch's batch at ``step`` (epoch-local:
        steps fold onto ``steps_per_epoch``; advance ``epoch`` in the
        key for the next pass)."""
        s = int(step) % self.steps_per_epoch
        lo = s * self.global_batch
        return self.perm[lo:lo + self.global_batch]

    def rank_indices(self, step: int, rank: int, world: int) \
            -> np.ndarray:
        """Rank ``rank``'s slice of the step's global batch. The
        global batch must divide evenly — the resize rule: keep
        ``global_batch`` a multiple of every world size you may shrink
        to."""
        if world <= 0 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside [0, {world})")
        if self.global_batch % world:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"world {world} — pick a resize-compatible batch")
        g = self.global_indices(step)
        per = self.global_batch // world
        return g[rank * per:(rank + 1) * per]

    def remaining(self, next_step: int) -> np.ndarray:
        """Sample ids this epoch not yet consumed when the next step
        to run is ``next_step`` — the set a resumed world repartitions."""
        s = int(next_step) % self.steps_per_epoch
        return self.perm[s * self.global_batch:
                         self.steps_per_epoch * self.global_batch]


def _decor(name: str, kind: str, rank: int) -> str:
    if kind == "sharded":
        return f"{name}@shard{rank:04d}"
    if kind == "per_rank":
        return f"{name}@rank{rank:04d}"
    return name


class ClusterCheckpoint:
    """One rank's handle on the coordinated checkpoint of a collective
    job. All ranks construct it over the same ``root`` (shared fs)
    and call ``maybe_save(step, ...)`` every step with their share of
    the state; restore reshards to whatever (rank, world) is asking.
    """

    def __init__(self, root: str, rank: int | None = None,
                 world: int | None = None,
                 every_steps: int | None = None,
                 every_seconds: float | None = None,
                 async_save: bool | None = None,
                 merge_timeout: float = 60.0,
                 store: CheckpointStore | None = None):
        env = os.environ.get
        self.root = root
        self.rank = int(rank if rank is not None
                        else env("PADDLE_TRAINER_ID", "0"))
        self.world = int(world if world is not None
                         else env("PADDLE_TRAINERS_NUM", "1"))
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"rank {self.rank} outside world {self.world}")
        self.every_steps = every_steps if every_steps is not None \
            else _env_opt_int("PADDLE_TPU_CKPT_EVERY_STEPS")
        self.every_seconds = every_seconds if every_seconds is not None \
            else _env_opt_float("PADDLE_TPU_CKPT_EVERY_SECONDS")
        if async_save is None:
            async_save = env("PADDLE_TPU_CKPT_ASYNC", "1") \
                not in ("", "0", "false")
        self.async_save = bool(async_save)
        self.merge_timeout = float(merge_timeout)
        self.store = store or CheckpointStore(root)
        self._last_save_t = time.monotonic()

    # -- cadence --------------------------------------------------------
    def _intent_path(self, step: int) -> str:
        return os.path.join(self.root, f"intent-{step:010d}.json")

    def _write_intent(self, step: int):
        import json
        os.makedirs(self.root, exist_ok=True)
        tmp = self._intent_path(step) + f".tmp{self.rank}"
        with open(tmp, "w") as f:
            json.dump({"step": int(step)}, f)
        os.replace(tmp, self._intent_path(step))

    def _intent_pending(self, step: int) -> bool:
        return os.path.exists(self._intent_path(step))

    def due(self, step: int) -> bool:
        """Is a coordinated save agreed for ``step``? Pure function of
        (step modulus, intent files) so every rank answers alike."""
        if self.every_steps and step > 0 \
                and step % self.every_steps == 0:
            return True
        return self._intent_pending(step)

    def maybe_save(self, step: int, replicated=None, sharded=None,
                   per_rank=None, extra_meta=None) -> int | None:
        """Save iff ``step`` is a coordinated save point; returns the
        step saved or None. Rank 0 additionally arms the seconds
        cadence by publishing an intent for ``step + 1`` — one step of
        lead so every rank sees it in time. A rank that diverges past
        an intent simply skips that version (the merge times out and
        the previous manifest stays current — degraded, never torn).
        """
        fire = self.due(step)
        if self.rank == 0 and self.every_seconds and not fire \
                and not self._intent_pending(step + 1) \
                and time.monotonic() - self._last_save_t \
                >= self.every_seconds:
            self._write_intent(step + 1)
        if not fire:
            return None
        return self.save(step, replicated=replicated, sharded=sharded,
                         per_rank=per_rank, extra_meta=extra_meta)

    # -- save -----------------------------------------------------------
    def _build_part(self, replicated, sharded, per_rank):
        replicated = dict(replicated or {})
        sharded = dict(sharded or {})
        per_rank = dict(per_rank or {})
        layout = {}
        for d, kind in ((replicated, "replicated"),
                        (sharded, "sharded"), (per_rank, "per_rank")):
            for name in d:
                if name in layout:
                    raise ValueError(
                        f"{name}: appears under two layout kinds")
                if "@" in name:
                    raise ValueError(
                        f"{name}: '@' is reserved for shard/rank "
                        "decoration")
                layout[name] = kind
        for name, val in sharded.items():
            # a tensor's ndim without a host copy (a CUDA tensor has no
            # numpy view)
            if (val.ndim if hasattr(val, "ndim")
                    else np.asarray(val).ndim) == 0:
                raise ValueError(
                    f"{name}: scalars cannot be sharded — declare it "
                    "replicated")
        part = {}
        if self.rank == 0:
            part.update(replicated)
        for name, val in sharded.items():
            part[_decor(name, "sharded", self.rank)] = val
        for name, val in per_rank.items():
            part[_decor(name, "per_rank", self.rank)] = val
        return part, layout

    def save(self, step: int, replicated=None, sharded=None,
             per_rank=None, extra_meta=None) -> int:
        """Commit this rank's part of cluster version ``step`` (and,
        on rank 0, the merge). With ``async_save`` both ride the
        store's writer thread and the step returns immediately."""
        step = int(step)
        part, layout = self._build_part(replicated, sharded, per_rank)
        meta = {"cluster": {"world": self.world, "layout": layout,
                            "extra": extra_meta}}
        _flight.record("elastic", "cluster_save", step=step,
                       rank=self.rank, world=self.world,
                       mode="async" if self.async_save else "sync")
        if self.async_save:
            self.store.save_part_async(part, step, self.rank,
                                       self.world)
            if self.rank == 0:
                self.store.merge_parts_async(
                    step, self.world, meta=meta,
                    timeout=self.merge_timeout)
        else:
            self.store.save_part(part, step, self.rank, self.world)
            if self.rank == 0:
                deadline = time.monotonic() + self.merge_timeout
                while len(_manifest.list_parts(self.root, step)) \
                        < self.world:
                    if time.monotonic() >= deadline:
                        raise ClusterCheckpointError(
                            f"step {step}: missing parts after "
                            f"{self.merge_timeout}s")
                    time.sleep(0.02)
                self.store.merge_parts(step, self.world, meta=meta)
        self._last_save_t = time.monotonic()
        if self.rank == 0:
            self._gc_intents(step)
        return step

    def _gc_intents(self, upto: int):
        """Drop consumed intent files (best-effort; they are tiny)."""
        import glob
        for p in glob.glob(os.path.join(self.root, "intent-*.json")):
            try:
                if int(os.path.basename(p)[7:-5]) <= upto:
                    os.unlink(p)
            except (ValueError, OSError):
                pass

    def wait(self):
        """Drain this rank's pending async writes (surfacing errors).
        A merge timeout surfaces here as ManifestError — the job keeps
        the previous restorable version."""
        self.store.wait()

    # -- restore --------------------------------------------------------
    @staticmethod
    def exists(root: str) -> bool:
        return CheckpointStore.exists(root)

    def restore(self, rank: int | None = None,
                world: int | None = None,
                step: int | None = None) -> tuple[dict, dict]:
        """(state, info) of the newest committed cluster version,
        resharded for (rank, world) — defaults to this handle's.
        ``state`` maps the ORIGINAL names: replicated arrays in full,
        sharded arrays cut on the new world's np.array_split
        partition, per_rank arrays exactly at the same world else
        ``None``. ``info`` carries step / saved_world / extra."""
        t0 = time.perf_counter()
        rank = self.rank if rank is None else int(rank)
        world = self.world if world is None else int(world)
        payload = self.store.latest_manifest(step)
        meta = payload.get("meta") or {}
        cluster = meta.get("cluster")
        if cluster is None:
            raise ClusterCheckpointError(
                f"{self.root}: manifest at step {payload['step']} has "
                "no cluster layout — not a coordinated checkpoint")
        saved_world = int(cluster["world"])
        layout = cluster["layout"]
        arrays = payload["arrays"]
        state: dict = {}
        for name, kind in layout.items():
            if kind == "replicated":
                state[name] = self.store.materialize(arrays[name])
            elif kind == "sharded":
                state[name] = self._restore_resharded(
                    arrays, name, saved_world, rank, world)
            else:  # per_rank
                key = _decor(name, "per_rank", rank)
                state[name] = self.store.materialize(arrays[key]) \
                    if world == saved_world and key in arrays else None
        info = {"step": int(payload["step"]),
                "saved_world": saved_world,
                "extra": cluster.get("extra")}
        if rank == 0:
            # leftovers of the torn save the crash interrupted: purge
            # uncommitted parts/intents past the committed step so a
            # resumed (possibly resized) gang can never merge a stale
            # piece into a fresh version (merge_parts also rejects
            # wrong-world parts — this keeps the dir clean)
            self._purge_stale(int(payload["step"]))
        dt = time.perf_counter() - t0
        _RESUME_SECONDS.observe(dt)
        _flight.record("elastic", "cluster_restore",
                       step=info["step"], rank=rank, world=world,
                       saved_world=saved_world, seconds=round(dt, 6))
        return state, info

    def _purge_stale(self, committed_step: int):
        import glob
        for pat, off in (("part-*.json", 5), ("intent-*.json", 7)):
            for p in glob.glob(os.path.join(self.root, pat)):
                base = os.path.basename(p)
                try:
                    if int(base[off:off + 10]) > committed_step:
                        os.unlink(p)
                except (ValueError, OSError):
                    pass

    def _restore_resharded(self, arrays: dict, name: str,
                           saved_world: int, rank: int,
                           world: int) -> np.ndarray:
        """Stitch the saved per-rank pieces of ``name`` and cut this
        rank's np.array_split share of the new world, reading only the
        byte ranges that overlap (piece chunks are never fully read
        unless owned)."""
        pieces, row0 = [], 0
        for r in range(saved_world):
            ent = arrays.get(_decor(name, "sharded", r))
            if ent is None:
                raise ClusterCheckpointError(
                    f"{name}: missing shard piece for saved rank {r}")
            shape = tuple(ent["shape"])
            if not shape:
                raise ClusterCheckpointError(
                    f"{name}: scalar shard piece cannot be resharded")
            pieces.append((row0, shape[0], ent))
            row0 += shape[0]
        total = row0
        base, rem = divmod(total, world)
        lo = rank * base + min(rank, rem)
        hi = lo + base + (1 if rank < rem else 0)
        first = pieces[0][2]
        trailing = tuple(first["shape"][1:])
        dtype = np.dtype(first["dtype"])
        if lo == hi:
            return np.empty((0,) + trailing, dtype=dtype)
        out = []
        for r0, rows, ent in pieces:
            a, b = max(lo, r0), min(hi, r0 + rows)
            if a >= b:
                continue
            out.append(self.store.read_rows(ent, a - r0, b - r0))
        return out[0] if len(out) == 1 else np.concatenate(out, axis=0)

    def latest_step(self) -> int | None:
        steps = self.store.steps()
        return steps[-1] if steps else None
