"""Progress-token stall watchdog (counterpart of
``paddle_tpu/observability/watchdog.py``).

A process whose heartbeat thread is alive but whose decode loop is
stuck looks healthy from outside. This module is the in-process half:
each tier registers a **progress token** — a counter it must keep
advancing while it has work — and the watchdog fires when a token goes
`deadline` seconds without progress while not idle:

  * serving engine — ``_wd_progress`` (advanced on every token and every
    retirement); idle = scheduler idle (an empty engine is never a
    stall);
  * any tier with a health predicate — ``watch_healthy`` (truthy =
    progress);
  * the launcher's heartbeat files — ``watch_heartbeats``, healthy while
    ``distributed.elastic.stale_ranks`` reports no hung rank.

On fire the watchdog raises ``paddle_tpu_watchdog_*`` metrics, records
a ``watchdog`` flight event, writes a postmortem bundle
(``observability.debug``, when ``PADDLE_TPU_DEBUG_DIR`` or the
constructor's ``debug_dir`` names a directory), invokes the token's
``on_stall`` callback, and — with ``PADDLE_TPU_WATCHDOG_SIGTERM=1`` or
``sigterm=True`` — re-raises SIGTERM at its own process so a
supervisor's respawn takes over, with the bundle already on disk.

A token fires ONCE per stall episode; any later progress clears the
episode so a recovered tier can stall (and dump) again. Probes that
return ``None`` unregister themselves — registrants hold only weakrefs
to their owners, so a dead engine's token evaporates instead of
pinning it.

The background poll thread starts only on ``start()`` (or when
``PADDLE_TPU_WATCHDOG`` is set at import, see ``observability``);
``check_once()`` is the deterministic entry point tests drive
directly.

Knobs: ``PADDLE_TPU_WATCHDOG`` (truthy = auto-start),
``PADDLE_TPU_WATCHDOG_INTERVAL`` (poll seconds, default 1),
``PADDLE_TPU_WATCHDOG_DEADLINE`` (default token deadline seconds,
default 300, read at registration time), ``PADDLE_TPU_WATCHDOG_SIGTERM``.
"""
from __future__ import annotations

import os
import signal
import threading
import time

from . import flight as _flight
from . import registry as _obs

__all__ = ["Watchdog", "WATCHDOG", "watch", "watch_healthy",
           "watch_heartbeats", "unwatch", "check_once", "default_deadline"]

_CHECKS = _obs.counter(
    "paddle_tpu_watchdog_checks_total",
    "watchdog poll passes over the registered progress tokens")
_STALLS = _obs.counter(
    "paddle_tpu_watchdog_stalls_total",
    "no-progress deadline expiries (one per stall episode), by token",
    ["token"])
_STALLED = _obs.gauge(
    "paddle_tpu_watchdog_stalled",
    "1 while a token is inside a stall episode, by token", ["token"])
_AGE = _obs.gauge(
    "paddle_tpu_watchdog_progress_age_seconds",
    "seconds since each token last made progress", ["token"])


def default_deadline() -> float:
    """Token deadline when the registrant does not pass one (env
    PADDLE_TPU_WATCHDOG_DEADLINE, read at call time so tests/jobs can
    retune without reimporting)."""
    try:
        return float(os.environ.get(
            "PADDLE_TPU_WATCHDOG_DEADLINE", "300") or 300)
    except ValueError:
        return 300.0


class _Token:
    __slots__ = ("name", "probe", "deadline", "idle", "on_stall",
                 "healthy", "last_value", "last_progress", "fired")

    def __init__(self, name, probe, deadline, idle, on_stall, healthy,
                 now):
        self.name = name
        self.probe = probe
        self.deadline = float(deadline)
        self.idle = idle
        self.on_stall = on_stall
        self.healthy = healthy     # True: probe is a health predicate
        self.last_value = None     # counter probes: last observed value
        self.last_progress = now
        self.fired = False


class Watchdog:
    """Registry of progress tokens + the poll loop; see module doc."""

    def __init__(self, interval: float | None = None,
                 debug_dir: str | None = None,
                 sigterm: bool | None = None, now=time.monotonic):
        if interval is None:
            interval = float(os.environ.get(
                "PADDLE_TPU_WATCHDOG_INTERVAL", "1.0") or 1.0)
        if sigterm is None:
            sigterm = os.environ.get(
                "PADDLE_TPU_WATCHDOG_SIGTERM", "") not in ("", "0")
        self.interval = interval
        self.debug_dir = debug_dir   # None -> PADDLE_TPU_DEBUG_DIR
        self.sigterm = bool(sigterm)
        self._now = now
        self._tokens: dict[str, _Token] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- registration ---------------------------------------------------
    def watch(self, name: str, probe, deadline: float | None = None,
              idle=None, on_stall=None, healthy: bool = False) -> str:
        """Register a progress token. ``probe`` returns the counter the
        tier must advance (or, with ``healthy=True``, a truthy health
        flag); ``None`` from the probe unregisters the token (dead
        weakref). ``idle`` (optional) returns True while the tier has
        no work — an idle tier never stalls and its deadline restarts
        when work appears."""
        tok = _Token(name, probe, deadline if deadline is not None
                     else default_deadline(), idle, on_stall, healthy,
                     self._now())
        with self._lock:
            self._tokens[name] = tok
        return name

    def watch_healthy(self, name: str, healthy_fn,
                      deadline: float | None = None,
                      on_stall=None) -> str:
        """Predicate token: progress = ``healthy_fn()`` truthy; fires
        after `deadline` seconds of continuous unhealth."""
        return self.watch(name, healthy_fn, deadline=deadline,
                          on_stall=on_stall, healthy=True)

    def watch_heartbeats(self, dir_: str, timeout: float,
                         expected: int, grace: float = 0.0,
                         deadline: float | None = None,
                         name: str = "elastic.heartbeats",
                         on_stall=None) -> str:
        """Arm the watchdog on the launcher-side heartbeat files: the
        token is healthy while ``elastic.stale_ranks`` reports no hung
        rank, so stale heartbeats become an in-process stall (bundle +
        metrics) instead of only a launcher kill."""
        def healthy():
            from ..distributed.elastic import stale_ranks
            return not stale_ranks(dir_, timeout, expected, grace=grace)

        return self.watch_healthy(
            name, healthy, deadline=deadline if deadline is not None
            else timeout, on_stall=on_stall)

    def unwatch(self, name: str) -> bool:
        with self._lock:
            tok = self._tokens.pop(name, None)
        for m in (_STALLS, _STALLED, _AGE):
            m.remove_matching(token=name)
        return tok is not None

    def tokens(self) -> list[str]:
        with self._lock:
            return sorted(self._tokens)

    def stalled(self) -> list[str]:
        with self._lock:
            return sorted(n for n, t in self._tokens.items() if t.fired)

    # -- the check ------------------------------------------------------
    def check_once(self, now: float | None = None) -> list[str]:
        """One poll pass over every token; returns the tokens that
        FIRED on this pass (entered a stall episode)."""
        t = self._now() if now is None else now
        _CHECKS.inc()
        with self._lock:
            toks = list(self._tokens.values())
        fired = []
        for tok in toks:
            try:
                if tok.idle is not None and tok.idle():
                    # no work: reset the clock AND the baseline so the
                    # first post-idle probe re-anchors progress
                    tok.last_progress = t
                    tok.last_value = None
                    if tok.fired:
                        tok.fired = False
                    _STALLED.labels(token=tok.name).set(0)
                    _AGE.labels(token=tok.name).set(0)
                    continue
                v = tok.probe()
            except Exception:
                continue        # transient probe failure: skip the pass
            if v is None:
                self.unwatch(tok.name)   # owner died (weakref probe)
                continue
            if tok.healthy:
                progressed = bool(v)
            else:
                progressed = tok.last_value is None \
                    or v != tok.last_value
                tok.last_value = v
            if progressed:
                tok.last_progress = t
                if tok.fired:
                    tok.fired = False
                _STALLED.labels(token=tok.name).set(0)
            age = t - tok.last_progress
            _AGE.labels(token=tok.name).set(age)
            if age > tok.deadline and not tok.fired:
                tok.fired = True
                self._fire(tok, age)
                fired.append(tok.name)
        return fired

    def _fire(self, tok: _Token, age: float):
        _STALLS.labels(token=tok.name).inc()
        _STALLED.labels(token=tok.name).set(1)
        _flight.record("watchdog", "stall", token=tok.name,
                       age_s=round(age, 3), deadline_s=tok.deadline)
        from . import debug as _debug
        if self.sigterm:
            # escalation is armed BEFORE the bundle write: the stall
            # may itself be a hung filesystem, and the dump would then
            # wedge this poll thread too — the process must still die
            # within the grace period with whatever evidence made it to
            # disk. The hard exit also covers a main thread wedged
            # inside a blocking C call, where a PYTHON SIGTERM handler
            # (the observability dump hook runs only on the main
            # thread) is queued forever.
            _debug.arm_hard_exit(name="watchdog-sigterm-escalate")
        path = _debug.try_write_bundle(f"watchdog:{tok.name}",
                                       self.debug_dir)
        # stall episodes surface on the fleet dashboard (with their
        # bundle path) when a telemetry agent is armed; no-op otherwise
        from . import agent as _agent
        # attr is `name`, not `token`: the agent's credential redaction
        # blanks TOKEN-ish keys, and a progress-token name is the one
        # thing the dashboard must show
        _agent.publish_event("watchdog_stall", name=tok.name,
                             age_s=round(age, 3),
                             deadline_s=tok.deadline, bundle=path)
        if tok.on_stall is not None:
            try:
                tok.on_stall(tok.name, age, path)
            except Exception:
                pass
        if self.sigterm:
            os.kill(os.getpid(), signal.SIGTERM)

    # -- background thread ---------------------------------------------
    def start(self, interval: float | None = None) -> "Watchdog":
        if self._thread is not None:
            return self
        if interval is not None:
            self.interval = interval
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.check_once()
                except Exception:
                    pass    # the watchdog itself must never die

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# process-wide watchdog + module-level shortcuts (tiers register here)
WATCHDOG = Watchdog()
watch = WATCHDOG.watch
watch_healthy = WATCHDOG.watch_healthy
watch_heartbeats = WATCHDOG.watch_heartbeats
unwatch = WATCHDOG.unwatch
check_once = WATCHDOG.check_once
