"""Fault-injection harness (the port's copy of
``paddle_tpu/distributed/fleet/runtime/fault_injection.py``: the same
class, knobs, names and defaults, so a chaos drill's environment arms
both packages alike).

The port calls it from the checkpoint chunk writer
(``checkpoint/chunks.py``, kill-after-bytes between a chunk's fsync and
its rename), the serving engine's decode step (``serving/engine.py``,
the ``serving_decode`` stall, inside the step lock), the wire
(``rpc.py``: frame faults, the kill before dispatch or before the
reply) and the PS shard's dispatch (the ``dispatch`` stall point). The
trainer, replication and cold-tier hooks the knobs below name belong to
tiers of the JAX package not ported yet (ROADMAP.md A); their knobs are
parsed and kept here all the same.

Env-driven (all optional; a hook pays one attribute check when nothing
is configured):

  PADDLE_PS_FAULT_DROP=p        drop an outgoing frame with prob p — the
                                socket is closed instead, so the peer
                                sees EOF and the client retry path runs
  PADDLE_PS_FAULT_DELAY=sec     sleep before every send (latency)
  PADDLE_PS_FAULT_TRUNCATE=p    send only the first half of a frame,
                                then close the connection
  PADDLE_PS_FAULT_CORRUPT=p     flip bytes inside the frame BODY (the
                                header's length field stays intact so
                                the peer reads a full frame and the CRC
                                check rejects it — corrupting the length
                                would model a hung peer, not a bad one)
  PADDLE_PS_FAULT_KILL_AFTER=N  server: os._exit after N handled
                                requests
  PADDLE_PS_FAULT_KILL_AFTER_BYTES=N  checkpoint writer: os._exit once
                                N payload bytes have been written
                                (kill-mid-save crash tests)
  PADDLE_PS_FAULT_KILL_AT_STEP=N  trainer: os._exit at the START of
                                training step N (elastic.note_step is
                                the hook) — the deterministic SIGKILL
                                for gang-restart chaos drills
  PADDLE_PS_FAULT_KILL_POINT=recv|reply   kill before dispatch (request
                                lost) or after commit-before-reply (the
                                hard exactly-once case); default reply
  PADDLE_PS_FAULT_STALL=sec     hang injection: sleep this long at the
                                stall point (a wedged-not-dead tier —
                                what the observability watchdog must
                                catch; the in-flight op pins the tier
                                non-idle while its progress counter
                                freezes)
  PADDLE_PS_FAULT_STALL_POINT=dispatch|serving_decode|trainer_step
                                where to stall: the PS server's
                                dispatch path, the serving engine's
                                decode step (the step thread wedges
                                INSIDE its step lock — the chaos-drill
                                fault for the serving tier,
                                docs/DEBUGGING.md), or the trainer's
                                per-step elastic.note_step hook (hung
                                rank drills — step counter freezes
                                while the heartbeat keeps beating)
  PADDLE_PS_FAULT_SIDE=client|server|both   which transport end injects
                                (default both — set it when client and
                                server share one process env)
  PADDLE_PS_FAULT_SEED=n        deterministic fault schedule

Frame-granular faults (multiplexed channels): target ONE mux frame by
request id — the point is proving a fault is contained to its own call
while concurrent calls on the same socket complete untouched.

  PADDLE_PS_FAULT_FRAME_ACTION=corrupt|drop|delay   what to do to the
                                matched frame: flip a body byte (peer
                                answers that id with a retryable wire
                                error), swallow it (that call times
                                out), or hold it back so later frames
                                overtake it on the wire
  PADDLE_PS_FAULT_FRAME_REQ=id  match: a full 64-bit request id, or
                                "seq:N" to match the low-32-bit
                                sequence number (client token unknown
                                up front), or "any" for the first frame
  PADDLE_PS_FAULT_FRAME_DELAY=sec   hold-back for action=delay
                                (default 0.2)

The frame fault fires ONCE (first matching frame on an injecting side);
tests can re-arm programmatically via ``set_frame_fault``.

Replication-path faults (PS high availability, docs/PS_HA.md): target
the primary->standby WAL replication stream instead of the RPC frames.

  PADDLE_PS_FAULT_REPL_ACTION=drop|corrupt|delay   what to do to ONE
                                matched replication record: skip
                                shipping it (the standby sees a
                                sequence gap and resyncs from a fresh
                                bootstrap), flip its row bytes (the
                                per-record CRC rejects it -> resync),
                                or hold it back FRAME_DELAY seconds
  PADDLE_PS_FAULT_REPL_RECORD=N match: a replication sequence number,
                                or "any" for the first shipped record
                                (default any)
  PADDLE_PS_FAULT_KILL_AT_RECORD=N  standby: os._exit after APPLYING
                                its N-th replicated record (1-based;
                                0 disables) — the deterministic
                                standby-death for semi-sync
                                degradation drills

Like the frame fault, the replication fault fires ONCE; re-arm with
``set_repl_fault``.

Cold-tier faults (tiered embedding store, docs/PS_TIERED.md): target
one demand-paged read from the cold chunk store instead of the wire.

  PADDLE_PS_FAULT_COLD_ACTION=delay|error   what to do to ONE matched
                                cold-tier read: hold it back
                                COLD_DELAY seconds (slow chunk store),
                                or fail it (ColdReadError — the server
                                answers THAT pull with a retryable
                                error and nothing else wedges)
  PADDLE_PS_FAULT_COLD_TABLE=name  match: a table name, or "any"
                                (default any)
  PADDLE_PS_FAULT_COLD_ROW=key  match: a row key the faulting read
                                must include, or "any" (default any)
  PADDLE_PS_FAULT_COLD_DELAY=sec   hold-back for action=delay
                                (default 0.2)

Like the others, the cold fault fires ONCE; re-arm with
``set_cold_fault``.

A PADDLE_PS_FAULT_-prefixed env var that is NOT one of the above is a
typo (a chaos drill that silently injects nothing is worse than one
that fails loudly): `from_env` logs a warning naming it.

Counters (`injector().counters`) are exposed for tests and benchmarks.
"""
from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

__all__ = ["FaultInjector", "injector", "reset_injector",
           "KNOWN_FAULT_KNOBS"]

KILL_EXIT_CODE = 23

# every env knob from_env reads; anything else under the prefix is a
# misspelling the guard below flags
KNOWN_FAULT_KNOBS = frozenset({
    "PADDLE_PS_FAULT_DROP", "PADDLE_PS_FAULT_DELAY",
    "PADDLE_PS_FAULT_TRUNCATE", "PADDLE_PS_FAULT_CORRUPT",
    "PADDLE_PS_FAULT_KILL_AFTER", "PADDLE_PS_FAULT_KILL_POINT",
    "PADDLE_PS_FAULT_KILL_AFTER_BYTES",
    "PADDLE_PS_FAULT_KILL_AT_STEP", "PADDLE_PS_FAULT_STALL",
    "PADDLE_PS_FAULT_STALL_POINT", "PADDLE_PS_FAULT_SIDE",
    "PADDLE_PS_FAULT_SEED", "PADDLE_PS_FAULT_FRAME_ACTION",
    "PADDLE_PS_FAULT_FRAME_REQ", "PADDLE_PS_FAULT_FRAME_DELAY",
    "PADDLE_PS_FAULT_REPL_ACTION", "PADDLE_PS_FAULT_REPL_RECORD",
    "PADDLE_PS_FAULT_KILL_AT_RECORD",
    "PADDLE_PS_FAULT_COLD_ACTION", "PADDLE_PS_FAULT_COLD_TABLE",
    "PADDLE_PS_FAULT_COLD_ROW", "PADDLE_PS_FAULT_COLD_DELAY",
})

logger = logging.getLogger(__name__)


class FaultInjector:
    """One process-wide schedule of transport faults."""

    def __init__(self, drop: float = 0.0, delay: float = 0.0,
                 truncate: float = 0.0, corrupt: float = 0.0,
                 kill_after: int = 0, kill_point: str = "reply",
                 kill_after_bytes: int = 0, kill_at_step: int = -1,
                 stall: float = 0.0,
                 stall_point: str = "dispatch",
                 side: str = "both", seed: int = 0,
                 frame_action: str = "", frame_req: str = "",
                 frame_delay: float = 0.2,
                 repl_action: str = "", repl_record: str = "any",
                 kill_at_record: int = 0,
                 cold_action: str = "", cold_table: str = "any",
                 cold_row: str = "any", cold_delay: float = 0.2):
        self.drop = drop
        self.delay = delay
        self.truncate = truncate
        self.corrupt = corrupt
        self.kill_after = kill_after
        self.kill_point = kill_point
        self.kill_after_bytes = kill_after_bytes
        self.kill_at_step = kill_at_step
        self.stall = stall
        self.stall_point = stall_point
        self.side = side
        self.frame_action = frame_action
        self.frame_req = frame_req
        self.frame_delay = frame_delay
        self._frame_fired = False
        self.repl_action = repl_action
        self.repl_record = repl_record
        self.kill_at_record = kill_at_record
        self._repl_fired = False
        self.cold_action = cold_action
        self.cold_table = cold_table
        self.cold_row = cold_row
        self.cold_delay = cold_delay
        self._cold_fired = False
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()
        self._requests = 0
        self._bytes = 0
        self.counters = {"dropped": 0, "delayed": 0, "truncated": 0,
                         "corrupted": 0, "requests": 0, "bytes": 0,
                         "stalled": 0, "frame_faults": 0,
                         "repl_faults": 0, "cold_faults": 0}

    @classmethod
    def from_env(cls) -> "FaultInjector":
        # typo guard: a misspelled knob (KILL_AFTR, STAL, ...) would
        # otherwise arm NOTHING and the drill would "pass" fault-free
        unknown = sorted(k for k in os.environ
                         if k.startswith("PADDLE_PS_FAULT_")
                         and k not in KNOWN_FAULT_KNOBS)
        if unknown:
            logger.warning(
                "ignoring unknown fault knob(s) %s — known knobs: %s",
                ", ".join(unknown), ", ".join(sorted(KNOWN_FAULT_KNOBS)))
        e = os.environ.get
        return cls(
            drop=float(e("PADDLE_PS_FAULT_DROP", "0") or 0),
            delay=float(e("PADDLE_PS_FAULT_DELAY", "0") or 0),
            truncate=float(e("PADDLE_PS_FAULT_TRUNCATE", "0") or 0),
            corrupt=float(e("PADDLE_PS_FAULT_CORRUPT", "0") or 0),
            kill_after=int(e("PADDLE_PS_FAULT_KILL_AFTER", "0") or 0),
            kill_point=e("PADDLE_PS_FAULT_KILL_POINT", "reply"),
            kill_after_bytes=int(
                e("PADDLE_PS_FAULT_KILL_AFTER_BYTES", "0") or 0),
            kill_at_step=int(
                e("PADDLE_PS_FAULT_KILL_AT_STEP", "-1") or -1),
            stall=float(e("PADDLE_PS_FAULT_STALL", "0") or 0),
            stall_point=e("PADDLE_PS_FAULT_STALL_POINT", "dispatch"),
            side=e("PADDLE_PS_FAULT_SIDE", "both"),
            seed=int(e("PADDLE_PS_FAULT_SEED", "0") or 0),
            frame_action=e("PADDLE_PS_FAULT_FRAME_ACTION", "") or "",
            frame_req=e("PADDLE_PS_FAULT_FRAME_REQ", "any") or "any",
            frame_delay=float(
                e("PADDLE_PS_FAULT_FRAME_DELAY", "0.2") or 0.2),
            repl_action=e("PADDLE_PS_FAULT_REPL_ACTION", "") or "",
            repl_record=e("PADDLE_PS_FAULT_REPL_RECORD", "any")
            or "any",
            kill_at_record=int(
                e("PADDLE_PS_FAULT_KILL_AT_RECORD", "0") or 0),
            cold_action=e("PADDLE_PS_FAULT_COLD_ACTION", "") or "",
            cold_table=e("PADDLE_PS_FAULT_COLD_TABLE", "any") or "any",
            cold_row=e("PADDLE_PS_FAULT_COLD_ROW", "any") or "any",
            cold_delay=float(
                e("PADDLE_PS_FAULT_COLD_DELAY", "0.2") or 0.2))

    @property
    def active(self) -> bool:
        return bool(self.drop or self.delay or self.truncate
                    or self.corrupt or self.kill_after
                    or self.kill_after_bytes or self.kill_at_step >= 0
                    or self.stall or self.frame_action
                    or self.repl_action or self.kill_at_record
                    or self.cold_action)

    def _applies(self, side: str | None) -> bool:
        return self.side == "both" or side is None or side == self.side

    # -- frame-granular faults (multiplexed channels) --------------------
    def set_frame_fault(self, action: str, req: str = "any",
                        delay: float = 0.2, side: str | None = None):
        """(Re)arm a one-shot fault against a single mux frame. `req`
        matches like PADDLE_PS_FAULT_FRAME_REQ: a full id, "seq:N" for
        the low-32-bit sequence, or "any"."""
        with self._lock:
            self.frame_action = action
            self.frame_req = str(req)
            self.frame_delay = delay
            self._frame_fired = False
            if side is not None:
                self.side = side

    def _frame_matches(self, req_id: int) -> bool:
        spec = self.frame_req
        if spec in ("", "any"):
            return True
        if spec.startswith("seq:"):
            return (req_id & 0xFFFFFFFF) == int(spec[4:])
        return req_id == int(spec)

    def frame_fault(self, req_id: int,
                    side: str | None) -> tuple[str, float] | None:
        """One-shot fault check for a single outgoing mux frame.
        Returns None (send normally) or (action, delay_seconds) with
        action in {"corrupt", "drop", "delay"} — the fault is consumed
        by the first matching frame on an injecting side."""
        if not self.frame_action or not self._applies(side):
            return None
        with self._lock:
            if self._frame_fired or not self._frame_matches(req_id):
                return None
            self._frame_fired = True
            self.counters["frame_faults"] += 1
            return self.frame_action, self.frame_delay

    # -- replication-stream faults (PS HA, docs/PS_HA.md) ----------------
    def set_repl_fault(self, action: str, record: str = "any",
                       delay: float = 0.2):
        """(Re)arm a one-shot fault against a single primary->standby
        replication record. `record` is a replication sequence number
        or "any" for the next shipped record."""
        with self._lock:
            self.repl_action = action
            self.repl_record = str(record)
            self.frame_delay = delay
            self._repl_fired = False

    def repl_fault(self, seq: int) -> tuple[str, float] | None:
        """One-shot fault check for one outgoing replication record.
        Returns None (ship normally) or (action, delay_seconds) with
        action in {"drop", "corrupt", "delay"} — consumed by the first
        matching record."""
        if not self.repl_action:
            return None
        with self._lock:
            if self._repl_fired:
                return None
            spec = self.repl_record
            if spec not in ("", "any") and int(seq) != int(spec):
                return None
            self._repl_fired = True
            self.counters["repl_faults"] += 1
            return self.repl_action, self.frame_delay

    # -- cold-tier faults (tiered store, docs/PS_TIERED.md) --------------
    def set_cold_fault(self, action: str, table: str = "any",
                       row: str = "any", delay: float = 0.2):
        """(Re)arm a one-shot fault against a single cold-tier read.
        `table` matches a table name or "any"; `row` matches a key the
        faulting read must include, or "any"."""
        with self._lock:
            self.cold_action = action
            self.cold_table = str(table)
            self.cold_row = str(row)
            self.cold_delay = delay
            self._cold_fired = False

    def cold_fault(self, table: str,
                   keys) -> tuple[str, float] | None:
        """One-shot fault check for one cold-tier read. Returns None
        (read normally) or (action, delay_seconds) with action in
        {"delay", "error"} — consumed by the first matching read."""
        if not self.cold_action:
            return None
        with self._lock:
            if self._cold_fired:
                return None
            if self.cold_table not in ("", "any") \
                    and str(table) != self.cold_table:
                return None
            if self.cold_row not in ("", "any"):
                want = int(self.cold_row)
                if not any(int(k) == want for k in keys):
                    return None
            self._cold_fired = True
            self.counters["cold_faults"] += 1
            return self.cold_action, self.cold_delay

    def maybe_kill_at_record(self, n: int):
        """Standby kill switch: dies (os._exit, a SIGKILL stand-in)
        once it has APPLIED its ``kill_at_record``-th replicated record
        — the record is in its tables/WAL but possibly un-acked, the
        exact window the semi-sync degradation drill needs."""
        if self.kill_at_record and int(n) >= self.kill_at_record:
            os._exit(KILL_EXIT_CODE)

    # -- frame mangling (called from rpc.send_frame) --------------------
    def mangle(self, frame: bytes, body_off: int, side: str | None,
               req_id: int | None = None) -> tuple[bytes, str]:
        """Returns (frame', action) where action is one of
        "send" | "drop" | "truncate" | "skip" ("skip": the frame is
        consumed without a send AND without killing the connection —
        only the frame-granular path produces it)."""
        if req_id is not None and self.frame_action:
            act = self.frame_fault(req_id, side)
            if act is not None:
                kind, _delay = act
                if kind == "drop":
                    return frame, "skip"
                if kind == "delay":
                    time.sleep(_delay)
                elif kind == "corrupt" and len(frame) > body_off:
                    buf = bytearray(frame)
                    buf[body_off] ^= 0xFF
                    frame = bytes(buf)
        if not self._applies(side):
            return frame, "send"
        with self._lock:
            if self.delay:
                self.counters["delayed"] += 1
                delay = self.delay
            else:
                delay = 0.0
            if self.drop and self._rng.rand() < self.drop:
                self.counters["dropped"] += 1
                return frame, "drop"
            if self.truncate and self._rng.rand() < self.truncate:
                self.counters["truncated"] += 1
                return frame, "truncate"
            if self.corrupt and len(frame) > body_off \
                    and self._rng.rand() < self.corrupt:
                self.counters["corrupted"] += 1
                buf = bytearray(frame)
                pos = body_off + int(
                    self._rng.randint(0, len(frame) - body_off))
                buf[pos] ^= 0xFF
                frame = bytes(buf)
        if delay:
            time.sleep(delay)
        return frame, "send"

    # -- server kill switch ---------------------------------------------
    def count_request(self):
        """Server side, one call per received request; returns True when
        the kill threshold was just crossed."""
        with self._lock:
            self._requests += 1
            self.counters["requests"] = self._requests
            return bool(self.kill_after
                        and self._requests >= self.kill_after)

    def maybe_kill(self, point: str, armed: bool):
        if armed and self.kill_point == point:
            os._exit(KILL_EXIT_CODE)

    # -- hang injection (watchdog tests) ---------------------------------
    def maybe_stall(self, point: str, side: str | None = None):
        """Wedge the calling thread for `stall` seconds — a tier that is
        alive but making no progress, which is the failure mode the
        stall watchdog (observability/watchdog.py) exists to detect."""
        if self.stall and self.stall_point == point \
                and self._applies(side):
            with self._lock:
                self.counters["stalled"] += 1
            time.sleep(self.stall)

    # -- trainer kill switch (gang-restart chaos drills) ------------------
    def maybe_kill_at_step(self, step: int):
        """Dies (os._exit, no cleanup — a SIGKILL stand-in) at the
        START of training step ``kill_at_step``: state reflects the
        previous step, the coordinated checkpoint of it may be
        mid-flight — exactly the crash the gang-restart resume drill
        must survive. elastic.note_step calls this every step."""
        if self.kill_at_step >= 0 and int(step) >= self.kill_at_step:
            os._exit(KILL_EXIT_CODE)

    # -- writer kill switch (checkpoint crash tests) ---------------------
    def maybe_kill_bytes(self, n: int):
        """One call per payload write of n bytes; dies mid-save once the
        byte threshold is crossed (BEFORE the write's rename publishes
        it, so the crash leaves a torn, uncommitted tail)."""
        with self._lock:
            self._bytes += n
            self.counters["bytes"] = self._bytes
            armed = bool(self.kill_after_bytes
                         and self._bytes >= self.kill_after_bytes)
        if armed:
            os._exit(KILL_EXIT_CODE)


_injector: FaultInjector | None = None


def injector() -> FaultInjector:
    """Process-wide injector, configured from env on first use."""
    global _injector
    if _injector is None:
        _injector = FaultInjector.from_env()
    return _injector


def reset_injector(inj: FaultInjector | None = None):
    """Tests: swap in a fresh injector (None = re-read the env)."""
    global _injector
    _injector = inj
