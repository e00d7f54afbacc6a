"""Replicated serving: fault-tolerant router + replica supervision
(counterpart of ``paddle_tpu/serving/router.py``: the same ops, metric
names, env knobs and wire, so either package's ServingClient talks to
either package's Router, and a Router fronts either package's
replicas).

One `Router` fronts N `ServingServer` replicas over the serving wire
format — the same `ServingClient` that talks to a single replica talks
to the router unchanged. What the router adds:

  * least-loaded dispatch — each replica's live queue depth / active
    slots / page occupancy (from its enriched `ping`) plus the
    router's own in-flight reservation picks the emptiest replica;
  * session affinity — requests carrying a `session` key stick to one
    replica (their KV/prefix locality), remapped only when that
    replica stops being routable;
  * per-replica backpressure — a replica at its in-flight cap is not
    offered new work; when every routable replica is saturated the
    router itself replies "rejected" (well-formed backpressure, never
    a transport error);
  * health state machine — healthy -> suspect -> dead via ping
    timeouts, consecutive transport errors and MID-STREAM token
    stalls (the streamed forward's inter-frame timeout catches a
    replica whose frontend answers pings while its decode step is
    wedged); draining replicas (operator `drain_replica`, or the
    replica reporting it) stop receiving new work and retire instead
    of respawning;
  * failover — an in-flight `generate` that dies with its replica is
    replayed on a survivor with the SAME wire request id, so dedup
    semantics hold on every replica it may ever reach and the client
    sees exactly one authoritative final reply. Greedy decode is
    deterministic, so the survivor's tokens extend the tokens already
    streamed upstream (the relay forwards only the unseen tail);
  * staggered rollout — with a publish root configured, the
    `rollout` op hot-swaps the fleet to a published model version one
    replica at a time (the rest keep serving), health-gating each
    swap with a post-swap probe and rolling the flipped replicas AND
    the registry back to the pinned version on failure;
    `publish_watch=True` subscribes to the registry so every
    publication rolls out automatically;
  * elastic respawn — a dead replica with a respawn hook (subprocess
    via launch.py --serving_replicas, or `InProcessReplica` here) is rebuilt
    from its engine checkpoint (`Engine.from_checkpoint`); the router
    re-admits it after `ready_pings` healthy probes and ramps its
    in-flight cap from 1 (slow start) so a failover thundering herd
    cannot slam an empty, cold page pool — the warm-start
    re-admission path.

Observability: `paddle_tpu_router_*` metrics, `serving`-tier flight
events (`router_state`/`router_failover`/`router_respawn`), and one
watchdog health token per replica (`serving.router.<id>.<replica>`)
that fires when a replica stays suspect/dead past the deadline.

Env knobs (constructor kwargs win):
  PADDLE_TPU_ROUTER_PING_INTERVAL    health-probe cadence (s, 0.5)
  PADDLE_TPU_ROUTER_PING_TIMEOUT     per-probe timeout (s, 2.0)
  PADDLE_TPU_ROUTER_SUSPECT_AFTER    consecutive failures -> suspect (1)
  PADDLE_TPU_ROUTER_DEAD_AFTER       consecutive failures -> dead (3)
  PADDLE_TPU_ROUTER_TOKEN_STALL      inter-frame stall bound (s, 30)
  PADDLE_TPU_ROUTER_SUSPECT_HOLD     stall-suspicion hold (s, 5) — ping
                                     successes inside the hold do NOT
                                     clear suspicion (a wedged decode
                                     pings green)
  PADDLE_TPU_ROUTER_FAILOVER_RETRIES extra replicas tried per request (2)
  PADDLE_TPU_ROUTER_MAX_INFLIGHT     per-replica in-flight cap (32)
  PADDLE_TPU_ROUTER_READY_PINGS      healthy probes before re-admitting
                                     a respawned replica (1)
  PADDLE_TPU_ROUTER_RESPAWN_COOLDOWN seconds between respawn attempts (2)
"""
from __future__ import annotations

import hashlib
import itertools
import os
import socket
import socketserver
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np

from ..distributed.fleet.runtime.rpc import (PSRemoteError, RpcClient,
                                             RpcServerState, WireError,
                                             _env_float as _env_f,
                                             serve_connection)
from ..observability import (debug as _debug, flight as _flight,
                             meter as _meter, registry as _obs,
                             tracing as _tracing, watchdog as _watchdog)
from ..observability.collector import (TEL_READ_OPS, TelemetryCollector,
                                       telemetry_dispatch)

__all__ = ["ReplicaSpec", "Replica", "Router", "InProcessReplica"]

# replica state machine (gauge value in parentheses)
HEALTHY = "healthy"          # (0) routable
SUSPECT = "suspect"          # (1) errors/stalls; no NEW dispatch
DEAD = "dead"                # (2) past the error threshold; respawnable
RESPAWNING = "respawning"    # (3) respawn hook ran; awaiting ready pings
DRAINING = "draining"        # (4) finishing its queue; no new dispatch
RETIRED = "retired"          # (5) drained replica gone — never respawned
_STATE_VALUE = {HEALTHY: 0, SUSPECT: 1, DEAD: 2, RESPAWNING: 3,
                DRAINING: 4, RETIRED: 5}

_R_REQS = _obs.counter(
    "paddle_tpu_router_requests_total",
    "generate requests answered by the router, by final outcome",
    ["router", "outcome"], always=True)
_R_DISPATCH = _obs.counter(
    "paddle_tpu_router_dispatch_total",
    "forward attempts per replica (includes failover replays)",
    ["router", "replica"])
_R_FAILOVERS = _obs.counter(
    "paddle_tpu_router_failovers_total",
    "in-flight forwards replayed on another replica, by reason",
    ["router", "reason"], always=True)
_R_STATE = _obs.gauge(
    "paddle_tpu_router_replica_state",
    "replica health state (0 healthy, 1 suspect, 2 dead, 3 respawning, "
    "4 draining, 5 retired)", ["router", "replica"])
_R_RESPAWNS = _obs.counter(
    "paddle_tpu_router_respawns_total",
    "respawn attempts per replica", ["router", "replica"], always=True)
_R_STALLS = _obs.counter(
    "paddle_tpu_router_stream_stalls_total",
    "mid-generation inter-frame stalls detected on streamed forwards",
    ["router", "replica"], always=True)
_R_INFLIGHT = _obs.gauge(
    "paddle_tpu_router_inflight",
    "generate forwards currently in flight per replica (live)",
    ["router", "replica"])

_router_ids = itertools.count()


def _drop_router_series(rid: str):
    for m in (_R_REQS, _R_DISPATCH, _R_FAILOVERS, _R_STATE, _R_RESPAWNS,
              _R_STALLS, _R_INFLIGHT):
        m.remove_matching(router=rid)


class ReplicaSpec:
    """One replica the router fronts: a name, its current endpoint, and
    (optionally) how to rebuild it when it dies. ``respawn()`` returns
    the replacement's endpoint (or None = unchanged) — typically a
    wrapper around `Engine.from_checkpoint` + a fresh `ServingServer`
    (in-process: `InProcessReplica.spec()`; across processes: the
    launch.py respawn idiom / tests/torch_serving_replica.py)."""

    def __init__(self, name: str, endpoint: str, respawn=None,
                 max_inflight: int | None = None):
        self.name = str(name)
        self.endpoint = str(endpoint)
        self.respawn = respawn
        self.max_inflight = max_inflight


class Replica:
    """Router-side view of one replica. All mutable fields are guarded
    by the ROUTER's lock (one lock, no ordering hazards); the client
    pool has its own leaf lock (pop/append only, no I/O under it)."""

    def __init__(self, spec: ReplicaSpec, max_inflight: int):
        self.spec = spec
        self.name = spec.name
        self.endpoint = spec.endpoint
        # born UNCONFIRMED: routable only after a healthy probe — a
        # configured-but-not-yet-started replica must not swallow the
        # first requests' failover budget or inflate healthy_replicas
        self.state = RESPAWNING
        self.cold = False            # was dead: slow-start on readmit
        self.consecutive_errors = 0
        # mid-stream stalls, counted SEPARATELY: a wedged decode step
        # answers pings, so only a successful forward (decode proven
        # alive) or a respawn may reset this — green pings cannot.
        # Without it a permanently wedged replica flaps
        # suspect->healthy forever and never reaches dead/respawn.
        self.stall_errors = 0
        self.ready = 0               # healthy probes since dead/respawn
        self.inflight = 0            # router-side reservation
        self.max_inflight = spec.max_inflight or max_inflight
        self.slow_cap = self.max_inflight
        self.last_info: dict = {}    # last enriched-ping payload
        self.last_pick = 0           # dispatch seq of the last pick
        self.epoch = 0               # bumped per respawn: stale-failure guard
        self.suspect_until = 0.0     # stall-hold horizon
        self.respawn_inflight = False
        self.probe_inflight = False
        self.last_respawn = -1e9
        # ONE multiplexed client per replica: generates, pings, and
        # drain verbs interleave over its pooled channels — a streamed
        # generate no longer monopolizes a connection, and the health
        # probe shares the wire it is probing
        self._cli: RpcClient | None = None
        self._cli_lock = threading.Lock()

    @property
    def routable(self) -> bool:
        return self.state == HEALTHY

    @property
    def capacity(self) -> int:
        return min(self.max_inflight, self.slow_cap)

    def has_capacity(self) -> bool:
        return self.inflight < self.capacity

    def load_key(self) -> tuple:
        # least-loaded, then least page pressure, then least-recently-
        # picked — the last term breaks exact ties round-robin so an
        # idle fleet spreads instead of hammering the first replica
        # (and a freshly respawned replica actually receives work)
        info = self.last_info
        return (self.inflight + int(info.get("queue_depth", 0))
                + int(info.get("active_slots", 0)),
                float(info.get("occupancy", 0.0)),
                self.last_pick)

    def reset_channel(self):
        """Close the shared mux client (respawn/endpoint change)."""
        with self._cli_lock:
            cli, self._cli = self._cli, None
        if cli is not None:
            cli.close()


class Router(socketserver.ThreadingTCPServer):
    """Wire-compatible front for N serving replicas (module docstring).

    Ops: everything `ServingServer` speaks — `generate` (streamed or
    one-shot) is forwarded with failover, `ping`/`stats`/`metrics`/
    `debug_dump` answer locally — plus `drain_replica` for graceful
    removal. The router's own RpcServerState dedups `generate` by the
    client's request id, and that SAME id pins every downstream
    forward, so a retry, a failover replay, and their combination all
    resolve to exactly one applied generation per client call."""

    allow_reuse_address = True
    daemon_threads = True

    READ_OPS = frozenset({"stats", "ping", "metrics", "debug_dump"}
                         | TEL_READ_OPS)

    def __init__(self, endpoint: str = "127.0.0.1:0", replicas=(),
                 secret: str | None = None,
                 telemetry_host: bool | None = None,
                 default_timeout: float = 120.0,
                 ping_interval: float | None = None,
                 ping_timeout: float | None = None,
                 suspect_after: int | None = None,
                 dead_after: int | None = None,
                 token_stall: float | None = None,
                 suspect_hold: float | None = None,
                 failover_retries: int | None = None,
                 max_inflight: int | None = None,
                 ready_pings: int | None = None,
                 respawn_cooldown: float | None = None,
                 publish_root: str | None = None,
                 publish_watch: bool = False):
        self.router_id = f"r{next(_router_ids)}"
        self.secret = secret
        self.default_timeout = default_timeout
        self.ping_interval = ping_interval if ping_interval is not None \
            else _env_f("PADDLE_TPU_ROUTER_PING_INTERVAL", 0.5)
        self.ping_timeout = ping_timeout if ping_timeout is not None \
            else _env_f("PADDLE_TPU_ROUTER_PING_TIMEOUT", 2.0)
        self.suspect_after = suspect_after if suspect_after is not None \
            else int(_env_f("PADDLE_TPU_ROUTER_SUSPECT_AFTER", 1))
        self.dead_after = dead_after if dead_after is not None \
            else int(_env_f("PADDLE_TPU_ROUTER_DEAD_AFTER", 3))
        self.token_stall = token_stall if token_stall is not None \
            else _env_f("PADDLE_TPU_ROUTER_TOKEN_STALL", 30.0)
        self.suspect_hold = suspect_hold if suspect_hold is not None \
            else _env_f("PADDLE_TPU_ROUTER_SUSPECT_HOLD", 5.0)
        self.failover_retries = failover_retries \
            if failover_retries is not None \
            else int(_env_f("PADDLE_TPU_ROUTER_FAILOVER_RETRIES", 2))
        self.max_inflight = max_inflight if max_inflight is not None \
            else int(_env_f("PADDLE_TPU_ROUTER_MAX_INFLIGHT", 32))
        self.ready_pings = ready_pings if ready_pings is not None \
            else int(_env_f("PADDLE_TPU_ROUTER_READY_PINGS", 1))
        self.respawn_cooldown = respawn_cooldown \
            if respawn_cooldown is not None \
            else _env_f("PADDLE_TPU_ROUTER_RESPAWN_COOLDOWN", 2.0)

        # online-learning rollout: with a publish root the
        # router coordinates staggered fleet hot swaps ("rollout" op —
        # one replica at a time, health-gated, automatic rollback to
        # the pinned version); publish_watch additionally subscribes
        # to the registry so every publication rolls out by itself
        self.publish_root = publish_root if publish_root is not None \
            else (os.environ.get("PADDLE_TPU_PUBLISH_DIR") or None)
        self._pub_registry = None
        self._pub_sub = None
        self._rollout_lock = threading.Lock()
        self.rollouts = 0
        self.rollout_rollbacks = 0
        if self.publish_root:
            from ..publish import VersionRegistry
            self._pub_registry = VersionRegistry(self.publish_root)
            if publish_watch:
                from ..publish import VersionSubscriber
                self._pub_sub = VersionSubscriber(
                    self.publish_root, registry=self._pub_registry,
                    swap_fn=lambda v, rec: self.rollout_version(v),
                    kinds=("gpt-decode",))

        self._replicas: dict[str, Replica] = {}
        self._pick_seq = itertools.count(1)
        self._sessions: OrderedDict[str, str] = OrderedDict()
        self._session_cap = 4096
        # prefix-affinity: sessionless requests sharing a
        # prompt prefix prefer the replica that served it last, so the
        # replica's radix prefix cache keeps hitting. A HINT only —
        # capacity/spill/failover rules are unchanged, and a miss just
        # falls through to least-loaded.
        self._prefix_affinity: OrderedDict[str, str] = OrderedDict()
        self._prefix_cap = 4096
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._bg_threads: list[threading.Thread] = []
        # telemetry hosting (the debug_dump-verb pattern): the router
        # can carry the fleet collector on its own dispatch so small
        # deployments need no extra process (PADDLE_TPU_TELEMETRY_HOST=1
        # or telemetry_host=True); agents then point
        # PADDLE_TPU_TELEMETRY_COLLECTOR at the router endpoint
        if telemetry_host is None:
            telemetry_host = os.environ.get(
                "PADDLE_TPU_TELEMETRY_HOST", "") == "1"
        self.collector = TelemetryCollector() if telemetry_host else None
        self._rpc = RpcServerState(read_ops=self.READ_OPS, secret=secret,
                                   expose_req_id=True)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                serve_connection(self.request, outer._dispatch,
                                 outer._rpc)

        host, port = endpoint.rsplit(":", 1)
        super().__init__((host, int(port)), Handler)
        self.endpoint = f"{host}:{self.server_address[1]}"
        weakref.finalize(self, _drop_router_series, self.router_id)
        for spec in replicas:
            self.add_replica(spec)

    # -- fleet membership ----------------------------------------------
    def add_replica(self, spec: ReplicaSpec) -> Replica:
        r = Replica(spec, self.max_inflight)
        with self._lock:
            if r.name in self._replicas:
                raise ValueError(f"duplicate replica name {r.name!r}")
            self._replicas[r.name] = r
        _R_STATE.labels(router=self.router_id,
                        replica=r.name).set(_STATE_VALUE[r.state])
        _R_INFLIGHT.labels(router=self.router_id, replica=r.name).set(0)
        # one watchdog health token per replica: fires when the replica
        # stays suspect/dead/respawning past the deadline (the fleet's
        # capacity is silently down a replica). Probes through a
        # weakref so a dead router unregisters itself.
        wr = weakref.ref(self)
        name = r.name

        def _healthy():
            router = wr()
            if router is None:
                return None          # unregisters the token
            rep = router._replicas.get(name)
            return rep is not None and rep.state in (HEALTHY, DRAINING,
                                                     RETIRED)

        tok = f"serving.router.{self.router_id}.{name}"
        _watchdog.WATCHDOG.watch_healthy(tok, _healthy)
        weakref.finalize(self, _watchdog.WATCHDOG.unwatch, tok)
        return r

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Router":
        self._stop_ev.clear()
        # one synchronous probe round BEFORE accepting requests: every
        # configured replica is confirmed (or counted against) once, so
        # the first client request never races the health machinery
        first = []
        for r in list(self._replicas.values()):
            with self._lock:
                if r.probe_inflight or r.state == RETIRED:
                    continue
                r.probe_inflight = True
            t = threading.Thread(target=self._probe_once, args=(r,),
                                 daemon=True)
            t.start()
            first.append(t)
        for t in first:
            t.join(timeout=self.ping_timeout + 1.0)
        serve = threading.Thread(target=self.serve_forever, daemon=True,
                                 name=f"router-{self.router_id}-serve")
        health = threading.Thread(target=self._health_loop, daemon=True,
                                  name=f"router-{self.router_id}-health")
        self._bg_threads = [serve, health]
        serve.start()
        health.start()
        if self._pub_sub is not None:
            self._pub_sub.start()
        return self

    def stop(self):
        self._stop_ev.set()
        if self._pub_sub is not None:
            self._pub_sub.stop()
        if self._bg_threads:         # shutdown() blocks unless
            self.shutdown()          # serve_forever is running
        self.server_close()
        for t in self._bg_threads:
            t.join(timeout=10)
        self._bg_threads = []
        with self._lock:
            replicas = list(self._replicas.values())
        for r in replicas:
            r.reset_channel()
            _watchdog.WATCHDOG.unwatch(
                f"serving.router.{self.router_id}.{r.name}")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- health state machine -------------------------------------------
    def _set_state(self, r: Replica, new: str):
        """Caller holds self._lock."""
        old = r.state
        if old == new:
            return
        r.state = new
        _R_STATE.labels(router=self.router_id,
                        replica=r.name).set(_STATE_VALUE[new])
        _flight.record("serving", "router_state", router=self.router_id,
                       replica=r.name, old=old, new=new,
                       consecutive=r.consecutive_errors)

    def _note_alive(self, r: Replica, info: dict):
        with self._lock:
            r.last_info = dict(info) if isinstance(info, dict) else {}
            now = time.monotonic()
            if now < r.suspect_until:
                # a wedged decode step answers pings: inside the stall
                # hold a green ping does NOT clear suspicion — only the
                # hold expiring (and then surviving dispatch) does
                return
            r.consecutive_errors = 0
            if r.last_info.get("draining") and r.state in (HEALTHY,
                                                           SUSPECT):
                self._set_state(r, DRAINING)
                return
            if r.state in (DEAD, RESPAWNING):
                r.ready += 1
                if r.ready >= self.ready_pings:
                    r.ready = 0
                    r.stall_errors = 0   # fresh incarnation
                    if r.cold:
                        # warm-start re-admission after a DEATH: the
                        # replacement engine has an EMPTY page pool and
                        # zero warmth — ramp its
                        # in-flight cap from 1 so the backlog cannot
                        # slam it (doubles per completed forward).
                        # First-ever confirmation of a configured
                        # replica skips the ramp (it may be a warm,
                        # long-running server the router just joined).
                        r.slow_cap = 1
                        r.cold = False
                    self._set_state(r, HEALTHY)
            elif r.state == SUSPECT:
                self._set_state(r, HEALTHY)

    def _note_failure(self, r: Replica, reason: str,
                      epoch: int | None = None):
        respawn = None
        with self._lock:
            if epoch is not None and epoch != r.epoch:
                return               # talked to a pre-respawn incarnation
            r.consecutive_errors += 1
            r.ready = 0
            if reason == "stall":
                # ping replies stay green while decode is wedged: hold
                # the suspicion so the next probe can't flip it back,
                # and count stalls on a ledger pings cannot reset — a
                # permanently wedged replica must still reach DEAD
                r.stall_errors += 1
                r.suspect_until = time.monotonic() + self.suspect_hold
            if r.consecutive_errors >= self.dead_after \
                    or r.stall_errors >= self.dead_after:
                if r.state in (DRAINING, RETIRED):
                    # a drained replica going dark is it EXITING — that
                    # is the drain completing, never a fault to respawn
                    self._set_state(r, RETIRED)
                else:
                    r.cold = True
                    self._set_state(r, DEAD)
                    respawn = self._arm_respawn(r)
            elif r.consecutive_errors >= self.suspect_after \
                    and r.state == HEALTHY:
                self._set_state(r, SUSPECT)
        if respawn is not None:
            respawn.start()

    def _arm_respawn(self, r: Replica) -> threading.Thread | None:
        """Caller holds self._lock; returns the (unstarted) respawn
        thread so the spec's hook never runs under the lock."""
        if r.spec.respawn is None or r.respawn_inflight:
            return None
        if time.monotonic() - r.last_respawn < self.respawn_cooldown:
            return None
        r.respawn_inflight = True
        r.last_respawn = time.monotonic()
        return threading.Thread(target=self._do_respawn, args=(r,),
                                daemon=True,
                                name=f"router-respawn-{r.name}")

    def _do_respawn(self, r: Replica):
        _R_RESPAWNS.labels(router=self.router_id, replica=r.name).inc()
        _flight.record("serving", "router_respawn",
                       router=self.router_id, replica=r.name,
                       endpoint=r.endpoint)
        try:
            new_ep = r.spec.respawn()
        except Exception as e:
            _flight.record("serving", "router_respawn_failed",
                           router=self.router_id, replica=r.name,
                           error=f"{type(e).__name__}: {e}")
            with self._lock:
                r.respawn_inflight = False
            return
        with self._lock:
            if new_ep:
                r.endpoint = str(new_ep)
            r.epoch += 1             # in-flight failures to the old
            r.consecutive_errors = 0  # incarnation are stale now
            r.stall_errors = 0
            r.suspect_until = 0.0
            r.ready = 0
            r.respawn_inflight = False
            self._set_state(r, RESPAWNING)
        r.reset_channel()

    def _probe(self, r: Replica):
        cli = self._client(r)
        epoch = r.epoch
        try:
            # fail-fast per-call override on the SHARED channel: the
            # probe rides the same wire the generates use, so a green
            # ping vouches for the path requests actually take
            info = cli.call({"op": "ping"}, timeout=self.ping_timeout,
                            deadline=self.ping_timeout * 2,
                            max_retries=0)
        except Exception:
            self._note_failure(r, "ping", epoch=epoch)
        else:
            self._note_alive(r, info)

    def _probe_once(self, r: Replica):
        try:
            self._probe(r)
        finally:
            with self._lock:
                r.probe_inflight = False

    def _health_loop(self):
        # each probe rides its own short-lived thread: a dead replica
        # blocks ITS probe for ping_timeout, never the others' cadence
        # — failure detection must not slow down exactly when several
        # replicas are sick. probe_inflight keeps probes of one
        # replica serial (one probe verdict per replica at a time,
        # even though the shared mux channel could carry many).
        while not self._stop_ev.wait(self.ping_interval):
            for r in list(self._replicas.values()):
                if self._stop_ev.is_set():
                    return
                with self._lock:
                    if r.probe_inflight or r.state == RETIRED:
                        continue
                    r.probe_inflight = True
                threading.Thread(
                    target=self._probe_once, args=(r,), daemon=True,
                    name=f"router-{self.router_id}-probe-{r.name}"
                ).start()

    # -- dispatch -------------------------------------------------------
    @staticmethod
    def _prefix_key(prompt) -> str:
        """Stable hash of the prompt's leading tokens (the shared
        system-prompt region). 64 tokens comfortably covers the page-
        aligned prefixes the replica-side radix cache can actually
        reuse without the router knowing any replica's page size."""
        head = np.ascontiguousarray(np.asarray(prompt).ravel()[:64],
                                    dtype=np.int64)
        return hashlib.blake2b(head.tobytes(), digest_size=8).hexdigest()

    def _pick(self, session: str | None, exclude: set,
              prefix: str | None = None) -> Replica | None:
        """Reserve the least-loaded routable replica (None = nothing
        routable with capacity). Pure in-memory under the router lock.
        Sticky preferences, strongest first: an established session,
        then the prompt-prefix affinity hint — both only when the
        preferred replica is routable with capacity, never overriding
        spill or failover exclusion."""
        with self._lock:
            owner = None
            if session is not None:
                name = self._sessions.get(session)
                owner = self._replicas.get(name) if name else None
                if owner is not None and owner.routable \
                        and owner.name not in exclude \
                        and owner.has_capacity():
                    self._sessions.move_to_end(session)
                    owner.inflight += 1
                    owner.last_pick = next(self._pick_seq)
                    _R_INFLIGHT.labels(router=self.router_id,
                                       replica=owner.name
                                       ).set(owner.inflight)
                    return owner
            if session is None and prefix is not None:
                name = self._prefix_affinity.get(prefix)
                pref = self._replicas.get(name) if name else None
                if pref is not None and pref.routable \
                        and pref.name not in exclude \
                        and pref.has_capacity():
                    self._prefix_affinity.move_to_end(prefix)
                    pref.inflight += 1
                    pref.last_pick = next(self._pick_seq)
                    _R_INFLIGHT.labels(router=self.router_id,
                                       replica=pref.name
                                       ).set(pref.inflight)
                    return pref
            cands = [r for r in self._replicas.values()
                     if r.routable and r.name not in exclude
                     and r.has_capacity()]
            if not cands:
                return None
            r = min(cands, key=Replica.load_key)
            if session is None and prefix is not None:
                # remember where this prefix landed (dead/at-capacity
                # preferred replicas get overwritten here, so the hint
                # self-heals after failover)
                self._prefix_affinity[prefix] = r.name
                self._prefix_affinity.move_to_end(prefix)
                while len(self._prefix_affinity) > self._prefix_cap:
                    self._prefix_affinity.popitem(last=False)
            if session is not None and (owner is None
                                        or not owner.routable):
                # remap the session only when its replica stopped
                # being ROUTABLE — a transient at-capacity spike (or a
                # one-attempt exclusion) spills THIS request sideways
                # without forfeiting the session's KV/prefix locality
                self._sessions[session] = r.name
                self._sessions.move_to_end(session)
                while len(self._sessions) > self._session_cap:
                    self._sessions.popitem(last=False)
            r.inflight += 1
            r.last_pick = next(self._pick_seq)
            _R_INFLIGHT.labels(router=self.router_id,
                               replica=r.name).set(r.inflight)
            return r

    def _release(self, r: Replica, ok: bool):
        with self._lock:
            r.inflight = max(0, r.inflight - 1)
            _R_INFLIGHT.labels(router=self.router_id,
                               replica=r.name).set(r.inflight)
            if ok:
                # a completed forward is PROOF the decode path moves:
                # the one signal allowed to clear the stall ledger
                r.stall_errors = 0
                if r.slow_cap < r.max_inflight:
                    r.slow_cap = min(r.max_inflight, r.slow_cap * 2)

    def _client(self, r: Replica) -> RpcClient:
        """The replica's one multiplexed client, rebuilt lazily when
        the endpoint moved (respawn). Construction is lazy-connecting,
        so nothing blocks under the lock."""
        with r._cli_lock:
            cli = r._cli
            if cli is None or cli.endpoint != r.endpoint:
                old = cli
                cli = r._cli = RpcClient(
                    r.endpoint, secret=self.secret,
                    timeout=self.default_timeout,
                    deadline=self.default_timeout * 2,
                    max_retries=0)
            else:
                old = None
        if old is not None:
            old.close()
        return cli

    def _forward_req(self, req: dict) -> dict:
        fwd = {"op": "generate", "prompt": req["prompt"],
               "max_new_tokens": int(req.get("max_new_tokens", 16)),
               "deadline": req.get("deadline"),
               "timeout": req.get("timeout"),
               "priority": int(req.get("priority", 1)),
               "tenant": str(req.get("tenant", "default")),
               # ALWAYS stream downstream, whatever the client asked:
               # the inter-frame gap is the router's only mid-generation
               # stall signal, and TTFT becomes wire-observable
               "stream": True}
        # sampling knobs relay verbatim — the replica (not the router)
        # resolves a missing seed from the wire request id, and the
        # router pins that id across failover, so a relayed retry on a
        # survivor replica replays the identical token stream
        for key in ("temperature", "top_k", "top_p", "seed"):
            if key in req:
                fwd[key] = req[key]
        return fwd

    def _relay(self, req: dict, rid: int | None):
        """Generator: forward one generate with failover, yielding
        relayed token frames (consumed internally when the client did
        not ask for a stream). Returns the final reply dict. The
        tracing span opens HERE (first next()), not in _dispatch — a
        returned generator outlives the dispatch call, and the span
        must cover the actual relay work."""
        with _tracing.span("router.generate",
                           prompt_len=int(req["prompt"].size)) as sp:
            final = yield from self._relay_inner(req, rid)
            sp.attrs["status"] = final.get("status", "?") \
                if isinstance(final, dict) else "?"
            return final

    def _relay_inner(self, req: dict, rid: int | None):
        fwd = self._forward_req(req)
        tenant = fwd["tenant"]
        stream_up = bool(req.get("stream"))
        session = req.get("session")
        first_t = float(req.get("timeout") or self.default_timeout) + 5.0
        sent = 0                     # tokens already relayed upstream
        tried: set[str] = set()
        last_err: str | None = None
        pfx = self._prefix_key(req["prompt"]) if session is None else None
        for _attempt in range(self.failover_retries + 1):
            r = self._pick(session, tried, prefix=pfx)
            if r is None:
                break
            tried.add(r.name)
            epoch = r.epoch
            _R_DISPATCH.labels(router=self.router_id,
                               replica=r.name).inc()
            cli = self._client(r)
            ok = None   # True = channel fine, False = transport fault,
            #             None = abandoned (upstream died mid-relay)
            try:
                gen = cli.call_stream(fwd, req_id=rid, timeout=first_t,
                                      stream_timeout=self.token_stall)
                final = None
                try:
                    while final is None:
                        try:
                            frame = next(gen)
                        except StopIteration as stop:
                            final = stop.value \
                                if stop.value is not None else {}
                            break
                        toks = frame.get("tokens") \
                            if isinstance(frame, dict) else None
                        if toks is None:
                            continue
                        toks = [int(t) for t in
                                np.asarray(toks).ravel()]
                        idx = int(frame.get("index", 0))
                        # failover replay restarts from index 0 with
                        # identical (greedy-deterministic) tokens:
                        # relay only the unseen tail
                        new = idx + len(toks) - sent
                        if new > 0:
                            tail = toks[len(toks) - new:]
                            if stream_up:
                                yield {"tokens": np.asarray(tail,
                                                            np.int32),
                                       "index": sent}
                            sent += new
                finally:
                    gen.close()
                ok = True
            except PSRemoteError as e:
                # the replica DISPATCHED and failed (application
                # error): deterministic poison would fail everywhere —
                # report it, no failover
                ok = True
                _R_REQS.labels(router=self.router_id,
                               outcome="error").inc()
                _meter.METER.note_routed(tenant, "error")
                return {"status": "error", "error": str(e)}
            except (socket.timeout, WireError, ConnectionError,
                    OSError) as e:
                ok = False
                stalled = isinstance(e, socket.timeout)
                reason = "stall" if stalled else "transport"
                if stalled:
                    _R_STALLS.labels(router=self.router_id,
                                     replica=r.name).inc()
                last_err = f"{type(e).__name__}: {e}"
                _R_FAILOVERS.labels(router=self.router_id,
                                    reason=reason).inc()
                _flight.record("serving", "router_failover",
                               router=self.router_id, replica=r.name,
                               reason=reason, relayed=sent,
                               error=last_err)
                self._note_failure(r, reason, epoch=epoch)
                continue
            finally:
                # runs on EVERY exit — including GeneratorExit when the
                # upstream client dies mid-relay, which must not leak
                # the in-flight reservation (capacity would shrink
                # forever) or grow the slow-start cap. The shared mux
                # client needs no return/close: an abandoned stream
                # sends F_CANCEL and the channel itself stays pooled.
                self._release(r, ok is True)
            status = final.get("status", "?") \
                if isinstance(final, dict) else "?"
            if status == "rejected" \
                    and len(tried) <= self.failover_retries:
                # replica-level backpressure with replicas left to try:
                # spill sideways instead of bouncing the client — also
                # mid-stream (a failover can land on a saturated
                # replica; it applied nothing, and the tail relay
                # resumes cleanly on the next candidate)
                last_err = "replica backpressure"
                _R_FAILOVERS.labels(router=self.router_id,
                                    reason="backpressure").inc()
                continue
            if status == "rejected" and sent:
                break                # partial stream: NOT clean backpressure
            _R_REQS.labels(router=self.router_id, outcome=status).inc()
            _meter.METER.note_routed(tenant, status)
            return final
        # give-up reply. "rejected" means nothing was admitted ANYWHERE
        # (safe to resubmit); once tokens were streamed upstream the
        # request partially executed, so it must surface as an error —
        # a client treating it as clean backpressure would resubmit and
        # double-consume the streamed prefix.
        clean = sent == 0 and (last_err is None
                               or last_err == "replica backpressure")
        outcome = "rejected" if clean else "failed"
        _R_REQS.labels(router=self.router_id, outcome=outcome).inc()
        _meter.METER.note_routed(tenant, outcome)
        detail = "no routable replica with capacity" \
            if last_err is None else last_err
        if sent:
            detail = f"{sent} token(s) already streamed, then: {detail}"
        return {"status": "rejected" if clean else "error",
                "error": f"router: giving up after "
                         f"{len(tried) or 'no'} replica(s): {detail}"}

    # -- server ops ----------------------------------------------------
    def _dispatch(self, req: dict):
        op = req.get("op")
        if op == "ping":
            with self._lock:
                healthy = sum(1 for r in self._replicas.values()
                              if r.routable)
                queued = sum(int(r.last_info.get("queue_depth", 0))
                             + r.inflight
                             for r in self._replicas.values())
            return {"ok": healthy > 0, "router": True,
                    "draining": False, "queue_depth": queued,
                    "healthy_replicas": healthy,
                    "replicas": len(self._replicas)}
        if op == "stats":
            return self.stats()
        if op == "metrics":
            return _obs.prometheus_text()
        if op == "debug_dump":
            return _debug.dump_verb(req)
        if op and (op.startswith("tel_")
                   or op in ("tsdb_query", "alerts", "usage_report")):
            if self.collector is None:
                raise ValueError("telemetry collector not hosted here "
                                 "(set PADDLE_TPU_TELEMETRY_HOST=1)")
            req.pop("_req_id", None)
            return telemetry_dispatch(self.collector, req)
        if op == "drain_replica":
            return self._drain_replica(req)
        if op == "rollout":
            v = req.get("version")
            return self.rollout_version(None if v is None else int(v))
        if op == "generate":
            rid = req.pop("_req_id", None)
            req["prompt"] = np.asarray(req["prompt"], np.int32)
            rely = self._relay(req, rid)
            if req.get("stream"):
                return rely          # serve_connection drains it
            while True:              # consume the relay internally
                try:
                    next(rely)
                except StopIteration as stop:
                    return stop.value if stop.value is not None \
                        else {}
        req.pop("_req_id", None)
        raise ValueError(f"unknown op {op!r}")

    def _drain_replica(self, req: dict) -> dict:
        name = str(req.get("replica", ""))
        with self._lock:
            r = self._replicas.get(name)
            if r is None:
                raise ValueError(f"unknown replica {name!r}")
            self._set_state(r, DRAINING)
        # forward the drain verb so the replica itself stops admitting
        # (direct clients included) and finishes its queue — on the
        # replica's shared mux client, interleaved with whatever
        # in-flight generates it is finishing
        rep = self._client(r).call(
            {"op": "drain", "wait": bool(req.get("wait")),
             "timeout": req.get("timeout")},
            timeout=float(req.get("timeout") or 60) + 30,
            deadline=float(req.get("timeout") or 60) + 60,
            max_retries=1)
        return {"replica": name, "draining": True,
                "idle": rep.get("idle") if isinstance(rep, dict)
                else None}

    # -- staggered fleet rollout ------------------------------------------
    def _adopt_on(self, r: Replica, version: int) -> dict:
        """One replica's hot swap + health gate: adopt_version on its
        shared mux client, then a post-swap probe that must come back
        ok AND reporting the new version (a swap that 'succeeded' into
        a broken engine fails here). Raises on any failure."""
        cli = self._client(r)
        cli.call({"op": "adopt_version", "version": int(version)},
                 timeout=self.default_timeout,
                 deadline=self.default_timeout * 2, max_retries=0)
        info = cli.call({"op": "ping"}, timeout=self.ping_timeout,
                        deadline=self.ping_timeout * 2, max_retries=0)
        if not (isinstance(info, dict) and info.get("ok")
                and int(info.get("model_version", -1)) == int(version)):
            raise RuntimeError(
                f"post-swap probe on {r.name} reports "
                f"{info.get('model_version') if isinstance(info, dict) else info!r}, "
                f"wanted {version}")
        self._note_alive(r, info)
        return info

    def rollout_version(self, version: int | None = None) -> dict:
        """Staggered fleet hot swap to published ``version`` (default:
        the registry's latest). One replica at a time — the rest keep
        serving the old weights, so fleet capacity never drops by more
        than one replica's worth mid-rollout. Any adopt failure or
        post-swap probe failure aborts the rollout, re-adopts the
        fallback (the registry's pinned version when set, else each
        replica's pre-rollout version) on every replica already
        flipped, and rewinds the registry's latest pointer — the
        automatic-rollback contract."""
        if self._pub_registry is None:
            raise ValueError("rollout needs a publish root "
                             "(publish_root= or PADDLE_TPU_PUBLISH_DIR)")
        failure = None
        with self._rollout_lock:   # one rollout at a time, fleet-wide
            reg = self._pub_registry
            reg.reload(missing_ok=True)
            if version is None:
                version = reg.latest()
            version = int(version)
            if not version:
                return {"adopted": 0, "replicas": [],
                        "error": "nothing published yet"}
            pinned = reg.pinned()
            with self._lock:
                targets = [r for r in self._replicas.values()
                           if r.state in (HEALTHY, SUSPECT)]
            flipped: list[tuple[Replica, int]] = []  # (replica, prior)
            for r in targets:
                prior = int(r.last_info.get("model_version", 0))
                try:
                    self._adopt_on(r, version)
                except Exception as e:
                    err = f"{type(e).__name__}: {e}"
                    _flight.record("serving", "rollout_failed",
                                   router=self.router_id,
                                   replica=r.name, version=version,
                                   error=err)
                    self._restore_flipped(flipped, pinned, version)
                    self.rollout_rollbacks += 1
                    failure = {"adopted": None, "version": version,
                               "failed_on": r.name, "error": err}
                    break
                flipped.append((r, prior))
            else:
                self.rollouts += 1
                _flight.record("serving", "rollout",
                               router=self.router_id, version=version,
                               replicas=[r.name for r, _p in flipped])
                return {"adopted": version,
                        "replicas": [r.name for r, _p in flipped]}
        # rewinding the registry is a durable file commit — done after
        # the rollout lock drops so no rollout ever blocks behind an
        # fsync. The fleet is already restored; a rollout racing this
        # rewind re-reads `latest` and simply re-serves the fallback.
        failure["rolled_back"] = self._rewind_registry(pinned)
        return failure

    def _restore_flipped(self, flipped, pinned: int, bad: int):
        """Abort path, under the rollout lock: restore every
        already-flipped replica (pinned version when set, else its own
        pre-rollout version)."""
        for r, prior in flipped:
            back = pinned or prior
            if not back or back == bad:
                continue             # replica predates publishing
            try:
                self._adopt_on(r, back)
            except Exception:
                # the health loop owns this replica now: it will go
                # suspect/dead and respawn from its checkpoint
                _flight.record("serving", "rollback_failed",
                               router=self.router_id, replica=r.name,
                               version=back)

    def _rewind_registry(self, pinned: int) -> int | None:
        """Rewind the registry's latest pointer so subscribers and
        later rollouts never see the bad version as latest."""
        try:
            rec = self._pub_registry.rollback(pinned or None)
            return int(rec["version"])
        except Exception:
            return None

    def stats(self) -> dict:
        with self._lock:
            reps = {r.name: {"state": r.state,
                             "endpoint": r.endpoint,
                             "inflight": r.inflight,
                             "capacity": r.capacity,
                             "epoch": r.epoch,
                             "consecutive_errors": r.consecutive_errors,
                             "last_info": dict(r.last_info)}
                    for r in self._replicas.values()}
            sessions = len(self._sessions)
        return {"router": self.router_id, "endpoint": self.endpoint,
                "replicas": reps, "sessions": sessions,
                "healthy_replicas": sum(
                    1 for v in reps.values()
                    if v["state"] == HEALTHY)}


class InProcessReplica:
    """A ServingServer + Engine inside this process — the test/bench
    replica (production replicas are separate processes: the launch.py
    --serving_replicas respawn idiom, tests/torch_serving_replica.py).

    Builds the engine from a checkpoint root (`Engine.from_checkpoint`)
    so `kill()` + respawn exercises the real warm-start path: the
    replacement re-reads the manifest, starts with an empty page pool,
    and the router's slow-start re-admits it gradually. ``engine_kw``
    goes to `Engine.from_checkpoint`: the engine is on the card unless
    it holds ``device="cpu"``."""

    def __init__(self, ckpt_root: str, name: str = "replica",
                 engine_kw: dict | None = None,
                 endpoint: str = "127.0.0.1:0",
                 publish_root: str | None = None):
        self.ckpt_root = ckpt_root
        self.name = name
        self.engine_kw = dict(engine_kw or {})
        self._endpoint_req = endpoint
        # online-learning: the replica's adopt_version loads from this
        # root (server-side config, like the real subprocess replica's
        # PADDLE_TPU_PUBLISH_DIR env)
        self.publish_root = publish_root
        self.server = None
        self.engine = None

    def start(self) -> str:
        from .engine import Engine
        from .frontend import ServingServer
        self.engine = Engine.from_checkpoint(self.ckpt_root,
                                             **self.engine_kw)
        self.server = ServingServer(self.engine, self._endpoint_req,
                                    publish_root=self.publish_root)
        self.server.start()
        return self.server.endpoint

    @property
    def endpoint(self) -> str:
        return self.server.endpoint if self.server else ""

    def kill(self):
        """Crash, don't drain: sever the listener AND every live
        connection (in-flight streams die mid-frame), stop the decode
        loop. What a process kill looks like from the router's side."""
        srv, eng = self.server, self.engine
        self.server = self.engine = None
        if srv is not None:
            srv.kill()
        if eng is not None:
            eng.stop()

    def stop(self):
        srv, eng = self.server, self.engine
        self.server = self.engine = None
        if srv is not None:
            srv.stop()
        elif eng is not None:
            eng.stop()

    def respawn(self) -> str:
        """The ReplicaSpec.respawn hook: kill whatever is left, rebuild
        from the checkpoint on a fresh port, return the new endpoint."""
        self.kill()
        return self.start()

    def spec(self, **kw) -> ReplicaSpec:
        return ReplicaSpec(self.name, self.endpoint,
                           respawn=self.respawn, **kw)
