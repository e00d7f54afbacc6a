"""Elastic training: heartbeats, hang detection, job-level restart
(counterpart of ``paddle_tpu/distributed/elastic.py``).

Reference: python/paddle/distributed/fleet/elastic/* (ElasticManager
watching etcd heartbeats, restarting the pod on scale events or dead
nodes). No etcd here: heartbeats are files in a shared directory
(PADDLE_ELASTIC_HEARTBEAT_DIR), and the launcher's watch loop
(``distributed/launch.py --max_restarts``) is the manager: a crashed or
hung rank tears the whole job down and respawns it; training scripts
resume from their latest coordinated checkpoint
(``distributed/cluster_ckpt.py``). A process group cannot re-admit a
single lost rank mid-step, so the unit of recovery is the gang.

Heartbeat content is ``"start_ts beat_ts step"`` — three
space-separated tokens, the file ``rank<N>.hb``: the JAX package's
format, so a heartbeat directory written by either package is read
alike by the other. Staleness is decided on the CONTENT, not the file
mtime: the watcher (ElasticManager) tracks when each rank's content
last CHANGED on its own monotonic clock, so NFS mtime granularity or
cross-host clock skew cannot kill a healthy rank. The step token splits
"hung" (step frozen past ``step_deadline`` → restart) from "merely
slow" (step-lag straggler → flagged via ``paddle_tpu_elastic_*``
metrics and a flight event, never killed).
"""
from __future__ import annotations

import os
import threading
import time

from ..observability import flight as _flight, registry as _obs

__all__ = ["HeartbeatWriter", "start_heartbeat", "note_step",
           "read_heartbeats", "stale_ranks", "ElasticManager"]

_HB_SUFFIX = ".hb"

_HEARTBEATS = _obs.counter(
    "paddle_tpu_elastic_heartbeats_total",
    "heartbeat file writes by this process")
_STALE_RANKS = _obs.gauge(
    "paddle_tpu_elastic_stale_ranks",
    "ranks currently considered hung (stale heartbeat content or "
    "step frozen past deadline)")
_STRAGGLER_RANKS = _obs.gauge(
    "paddle_tpu_elastic_straggler_ranks",
    "ranks flagged slow-but-progressing (step lag over threshold; "
    "never killed)")
_STEP_LAG = _obs.gauge(
    "paddle_tpu_elastic_step_lag",
    "largest step lag behind the fastest rank at the last poll")
_RESTARTS = _obs.counter(
    "paddle_tpu_elastic_restarts_total",
    "whole-job elastic restarts, by trigger", ["reason"])
_GIVEUPS = _obs.counter(
    "paddle_tpu_elastic_crash_loop_giveups_total",
    "jobs abandoned by crash-loop detection (K failures in a window)")


def _hb_path(dir_, rank):
    return os.path.join(dir_, f"rank{rank}{_HB_SUFFIX}")


class HeartbeatWriter:
    """Writes this rank's heartbeat file every `interval` seconds from
    a daemon thread. Content is ``"start_ts beat_ts step"``; training
    loops feed the step via ``set_step`` (``note_step`` does it) so
    the launcher can tell a hung rank from a slow one."""

    def __init__(self, dir_: str, rank: int, interval: float = 1.0):
        self.path = _hb_path(dir_, rank)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None
        self._start_ts = None
        self._step = -1          # -1 = no step reported yet

    def start(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._start_ts = time.time()
        self._touch()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def set_step(self, step: int):
        """Record training progress; the next beat carries it. Cheap
        enough for every step (an int store — no IO on the step path).
        """
        self._step = int(step)

    def _touch(self):
        # "start beat step" content lets stale_ranks compute the job's
        # age (the startup grace window for ranks that haven't opted
        # in yet) and the watcher read progress. Write-then-rename: a
        # truncate-in-place write could be torn by a concurrent
        # stale_ranks read into a garbage start_ts that ends the grace
        # window early
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{self._start_ts} {time.time()} {self._step}")
        os.replace(tmp, self.path)
        _HEARTBEATS.inc()

    def _loop(self):
        while not self._stop.wait(self.interval):
            self._touch()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


_writer: HeartbeatWriter | None = None


def start_heartbeat(interval: float = 1.0):
    """Start this process's heartbeat if the launcher asked for one
    (PADDLE_ELASTIC_HEARTBEAT_DIR set). Idempotent; a training script
    calls it once before its first step."""
    global _writer
    dir_ = os.environ.get("PADDLE_ELASTIC_HEARTBEAT_DIR")
    if not dir_ or _writer is not None:
        return _writer
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    _writer = HeartbeatWriter(dir_, rank, interval).start()
    return _writer


def note_step(step: int):
    """Training loops call this once per step: publishes progress to
    the heartbeat (hang-vs-slow discrimination) and gives the fault
    injector its deterministic trainer-side hook
    (PADDLE_PS_FAULT_KILL_AT_STEP / STALL_POINT=trainer_step)."""
    w = _writer
    if w is not None:
        w.set_step(step)
    try:  # lazy: fleet package is heavier than this module
        from .fleet.runtime.fault_injection import injector
    except ImportError:  # pragma: no cover - fleet always ships
        return
    inj = injector()
    inj.maybe_kill_at_step(step)
    inj.maybe_stall("trainer_step")


def read_heartbeats(dir_: str, expected: int) -> dict:
    """Parse every expected rank's heartbeat file. Returns rank →
    ``{"start", "beat", "step", "mtime", "raw"}`` (fields None when
    unparseable / pre-upgrade formats) or None for a missing file.
    Legacy formats: one token = per-beat timestamp (no start, no
    step); two tokens = "start beat" (no step)."""
    out = {}
    for r in range(expected):
        p = _hb_path(dir_, r)
        try:
            mtime = os.path.getmtime(p)
            with open(p) as f:
                raw = f.read()
        except OSError:
            out[r] = None
            continue
        info = {"start": None, "beat": None, "step": None,
                "mtime": mtime, "raw": raw}
        tokens = raw.split()
        try:
            if len(tokens) == 1:
                info["beat"] = float(tokens[0])
            elif len(tokens) >= 2:
                info["start"] = float(tokens[0])
                info["beat"] = float(tokens[1])
                if len(tokens) >= 3:
                    step = int(tokens[2])
                    info["step"] = step if step >= 0 else None
        except ValueError:
            pass
        out[r] = info
    return out


def stale_ranks(dir_: str, timeout: float, expected: int,
                grace: float = 0.0, tracker: dict | None = None) \
        -> list[int]:
    """Ranks whose heartbeat is missing-after-grace or stale past
    `timeout` seconds. Staleness comes from heartbeat CONTENT, never
    the file mtime (NFS mtime granularity / clock skew must not kill
    a healthy rank):

    - with ``tracker`` (a dict the caller keeps across polls — the
      ElasticManager path): age since the content last CHANGED,
      measured on THIS process's monotonic clock. Fully skew-proof.
    - stateless calls: age of the beat timestamp written in the file
      (same clock as the writer's start stamp). mtime is only the
      last resort for unparseable content.

    Ranks that never wrote a file are only reported once SOME rank
    has (otherwise scripts that don't opt in would always look hung),
    and — when `grace` > 0 — only once the job has been beating for
    at least `grace` seconds (slow ranks legitimately write their
    first heartbeat later than fast ones; the launcher passes its
    heartbeat timeout here)."""
    now = time.time()
    mono = time.monotonic()
    hbs = read_heartbeats(dir_, expected)
    if not any(h is not None for h in hbs.values()):
        return []
    # job age from genuine start stamps only: a single-token legacy
    # PER-BEAT timestamp (or the fresh mtime) read as a start stamp
    # would pin job_age near zero for as long as the rank keeps
    # beating — grace would never expire and never-written ranks
    # would never be reported
    job_age = None
    if grace > 0:
        for h in hbs.values():
            if h is not None and h["start"] is not None:
                age0 = now - h["start"]
                job_age = age0 if job_age is None \
                    else max(job_age, age0)
    in_grace = grace > 0 and job_age is not None and job_age < grace
    stale = []
    for r, h in hbs.items():
        if h is None:
            if not in_grace:
                stale.append(r)
            continue
        if tracker is not None:
            prev = tracker.get(r)
            if prev is None or prev[0] != h["raw"]:
                tracker[r] = (h["raw"], mono)
                age = 0.0
            else:
                age = mono - prev[1]
        elif h["beat"] is not None:
            age = now - h["beat"]
        else:
            age = now - h["mtime"]
        if age > timeout:
            stale.append(r)
    return stale


class ElasticManager:
    """API-parity facade (reference fleet/elastic/manager.py): wraps
    the watchdog decision — should the job restart, and how many lives
    are left. PS mode additionally tracks SINGLE-SERVER restarts: a
    dead PS shard whose state lives in snapshots is respawned in place
    (workers' transport retry loops reconnect and resume) without
    burning a whole-job restart.

    Progress awareness: ``hung_ranks()`` reads heartbeat content once
    per poll and splits ranks three ways — hung (stale content, or
    step frozen past ``step_deadline`` while some other rank still
    advances), straggler (``straggler_lag``+ steps behind the fastest
    rank — flagged via metrics + flight event, never killed), and
    healthy. A rank frozen AT the max step is excused while any rank
    advances: it is blocked on the straggler at a collective, not
    hung itself. When every rank is frozen past the deadline the whole
    gang is hung (deadlocked collective) and all are reported."""

    def __init__(self, max_restarts: int = 0,
                 heartbeat_timeout: float = 30.0,
                 heartbeat_dir: str | None = None, world_size: int = 1,
                 max_server_restarts: int | None = None,
                 startup_grace: float | None = None,
                 step_deadline: float = 0.0,
                 straggler_lag: int = 10):
        self.max_restarts = max_restarts
        self.heartbeat_timeout = heartbeat_timeout
        self.heartbeat_dir = heartbeat_dir
        self.world_size = world_size
        self.restart_count = 0
        self.max_server_restarts = max_restarts \
            if max_server_restarts is None else max_server_restarts
        self.server_restart_count = 0
        self.startup_grace = heartbeat_timeout \
            if startup_grace is None else startup_grace
        self.step_deadline = float(step_deadline)
        self.straggler_lag = int(straggler_lag)
        self._tracker: dict = {}    # rank -> (raw content, mono ts)
        self._steps: dict = {}      # rank -> (step, mono ts advanced)
        self._flagged: set = set()  # stragglers already flight-logged
        self._stragglers: list = []

    def should_restart(self) -> bool:
        return self.restart_count < self.max_restarts

    def record_restart(self, reason: str = "crash"):
        self.restart_count += 1
        _RESTARTS.labels(reason=reason).inc()
        _flight.record("elastic", "job_restart", reason=reason,
                       attempt=self.restart_count,
                       budget=self.max_restarts)

    def record_giveup(self, reason: str, offender=None):
        _GIVEUPS.inc()
        _flight.record("elastic", "give_up", reason=reason,
                       offender=offender,
                       restarts=self.restart_count)

    def should_restart_server(self) -> bool:
        return self.server_restart_count < self.max_server_restarts

    def record_server_restart(self):
        self.server_restart_count += 1

    def reset_epoch(self):
        """Forget per-life observation state (call after every respawn
        — and after an exclusion resize, where ranks renumber)."""
        self._tracker.clear()
        self._steps.clear()
        self._flagged.clear()
        self._stragglers = []

    def hung_ranks(self) -> list[int]:
        """One watchdog poll: hung ranks to act on. Also refreshes
        ``stragglers()`` and the ``paddle_tpu_elastic_*`` gauges."""
        if not self.heartbeat_dir:
            return []
        stale = stale_ranks(self.heartbeat_dir,
                            self.heartbeat_timeout, self.world_size,
                            grace=self.startup_grace,
                            tracker=self._tracker)
        hbs = read_heartbeats(self.heartbeat_dir, self.world_size)
        now = time.monotonic()
        steps = {r: h["step"] for r, h in hbs.items()
                 if h is not None and h["step"] is not None}
        frozen = []
        for r, s in steps.items():
            prev = self._steps.get(r)
            if prev is None or s > prev[0]:
                self._steps[r] = (s, now)
            elif self.step_deadline > 0 \
                    and now - prev[1] > self.step_deadline:
                frozen.append(r)
        if frozen and steps:
            max_step = max(steps.values())
            if len(frozen) < len(steps):
                # somebody still advances: a frozen rank AT the front
                # is merely blocked on the laggards at a collective
                frozen = [r for r in frozen if steps[r] < max_step]
        hung = sorted(set(stale) | set(frozen))
        # stragglers: behind the front but still moving — flag, never
        # kill
        stragglers = []
        max_lag = 0
        if steps:
            max_step = max(steps.values())
            for r, s in steps.items():
                lag = max_step - s
                max_lag = max(max_lag, lag)
                if r not in hung and lag > self.straggler_lag:
                    stragglers.append(r)
                    if r not in self._flagged:
                        self._flagged.add(r)
                        _flight.record("elastic", "straggler",
                                       rank=r, step=s, lag=lag,
                                       threshold=self.straggler_lag)
        self._stragglers = sorted(stragglers)
        _STALE_RANKS.set(len(hung))
        _STRAGGLER_RANKS.set(len(self._stragglers))
        _STEP_LAG.set(max_lag)
        return hung

    def stragglers(self) -> list[int]:
        """Slow-but-progressing ranks from the LAST ``hung_ranks()``
        poll."""
        return list(self._stragglers)
