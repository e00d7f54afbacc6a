"""Network front-end for the serving engine (counterpart of
``paddle_tpu/serving/frontend.py``; the same ops on the same wire, so
either package's ServingClient talks to the other's ServingServer).

Speaks the fault-tolerant multiplexed wire
(distributed/fleet/runtime/rpc.py: data-only frames, CRC, optional
PADDLE_PS_SECRET HMAC handshake, client retry with stable request ids,
server-side dedup) — so a retried `generate` that raced a connection
drop is served from the dedup cache instead of decoding twice. The
handler threads see numpy only: tensors are made on the engine's step
thread.

Ops:
  {"op": "generate", "prompt": <int ndarray>, "max_new_tokens": n,
   "deadline": seconds|None, "timeout": seconds,
   "priority": tier (0 = highest, default 1), "tenant": str,
   "temperature": f (0 = greedy), "top_k": n, "top_p": f,
   "seed": int|absent, "stream": bool}
      -> {"status": "done"|"deadline"|"timeout"|"rejected"|"shed"|
                    "error",
          "tokens": <int32 ndarray>, ...}
    With "stream": true the server pushes F_STREAM frames
    {"tokens": <int32 ndarray>, "index": i} as tokens are decoded,
    then the normal final reply (whose "tokens" is the AUTHORITATIVE
    full list — stream frames are progress, the final frame is the
    dedup-cached result a retry sees). Streaming is what makes TTFT
    observable on the wire and lets a caller detect a server wedged
    mid-generation by the inter-frame gap.
    Backpressure AND tenant-quota rejections reply status="rejected";
    a queued request shed for a higher-priority submit replies
    status="shed" (the scheduler's admission control).
    Blocks the connection's handler thread until the request finishes
    (the engine keeps batching others meanwhile). Backpressure surfaces
    as status="rejected" — a well-formed reply, not a transport error,
    so the client's retry loop does not hammer a saturated server. A
    handler timeout CANCELS the request (slot+pages freed, partial
    tokens returned) before replying, because the reply is dedup-cached
    and a still-running request would decode tokens no retry could
    ever fetch.
  {"op": "stats"} -> engine.stats()   (queue depth, p50/p99, tokens/s,
    pool occupancy, preemptions, compile counters)
  {"op": "metrics"} -> Prometheus text over the process-wide telemetry
    registry — the serving scrape point
  {"op": "debug_dump", "write": bool} -> a full postmortem bundle
    (metrics + trace ring + flight rings + in-flight requests),
    optionally persisted into the server's own
    PADDLE_TPU_DEBUG_DIR (never a wire-chosen path)
  {"op": "drain"} -> {"draining": true, ...}  Graceful removal: stop
    admitting (submits reply "rejected"), finish everything queued or
    running; `ping`/`stats` report draining=true so a router routes
    around this replica. {"wait": true, "timeout": s} blocks until the
    queue ran dry (reply carries "idle").
  {"op": "ping"}  -> {"ok": true, "draining": bool, "queue_depth": n,
    "active_slots": n, "occupancy": f, "model_version": v,
    "tokens_per_s_per_chip": f, "mfu": f}  — the health/load probe
    (cheap: no latency sorting, no device sync); model_version is the
    published version the engine serves; the rate/MFU keys are the perf
    plane's cached per-chip view (Engine.perf_rates)
  {"op": "adopt_version", "version": v} -> {"adopted": v, ...}
    Zero-downtime hot swap to published version v from the server's
    CONFIGURED publish root (publish_root= / PADDLE_TPU_PUBLISH_DIR —
    the wire never chooses a path): Engine.warm_start's two-phase swap
    (read and upload off the step lock, a reference flip under it).

In-process use (tests, co-located workers) needs none of this — call
`Engine.submit` / `Engine.generate` directly.
"""
from __future__ import annotations

import socketserver
import threading
import time

import numpy as np

from ..distributed.fleet.runtime.rpc import (RpcClient, RpcServerState,
                                             serve_connection)
from ..observability import (debug as _debug, registry as _obs,
                             tracing as _tracing)
from .sampling import SamplingParams, derive_seed
from .scheduler import QueueFull

__all__ = ["ServingServer", "ServingClient"]


class ServingServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    READ_OPS = frozenset({"stats", "ping", "metrics", "debug_dump"})

    def __init__(self, engine, endpoint: str = "127.0.0.1:0",
                 secret: str | None = None,
                 default_timeout: float = 120.0,
                 publish_root: str | None = None):
        import os
        self.engine = engine
        self.default_timeout = default_timeout
        # the publish root adopt_version loads from is SERVER
        # configuration (arg or PADDLE_TPU_PUBLISH_DIR), never a
        # wire-chosen path — same rule as debug_dump's destination
        self.publish_root = publish_root if publish_root is not None \
            else (os.environ.get("PADDLE_TPU_PUBLISH_DIR") or None)
        # expose_req_id: the wire request id seeds stochastic sampling
        # when the client sent none — a transport retry AND a router
        # failover both relay the ORIGINAL id, so a replayed request
        # derives the same seed and emits the identical token sequence
        # (serving/sampling.py replay contract)
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
        self._thread: threading.Thread | None = None

    def start(self):
        self.engine.start()
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="serving-frontend")
        self._thread.start()
        return self

    def stop(self):
        self.shutdown()
        self.server_close()
        self.engine.stop()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _dispatch(self, req: dict):
        op = req.get("op")
        rid = req.pop("_req_id", None) if isinstance(req, dict) \
            else None
        if op == "ping":
            # the combined health + load probe: queue depth and
            # occupancy WITHOUT engine.stats()'s latency sort, so a
            # sub-second ping cadence costs nothing measurable
            # (perf_rates is two deque copies of cached values; no
            # device sync on this handler thread)
            sched = self.engine.scheduler
            rates = self.engine.perf_rates() \
                if hasattr(self.engine, "perf_rates") else {}
            return {"ok": True, "draining": bool(sched.draining),
                    "queue_depth": sched.queue_depth,
                    "active_slots": len(sched.active_requests()),
                    "occupancy": float(self.engine.pool.occupancy),
                    "model_version":
                        int(getattr(self.engine, "model_version", 0)),
                    "tokens_per_s_per_chip":
                        rates.get("tokens_per_s_per_chip", 0.0),
                    "mfu": rates.get("mfu", 0.0)}
        if op == "adopt_version":
            # online-learning hot swap: two-phase warm start from the
            # SERVER-configured publish root — the wire names only the
            # version number, never a path.
            if not self.publish_root:
                raise ValueError(
                    "no publish root configured on this replica "
                    "(publish_root= or PADDLE_TPU_PUBLISH_DIR)")
            version = int(req["version"])
            self.engine.warm_start(self.publish_root, step=version,
                                   version=version)
            return {"adopted": version,
                    "model_version": int(self.engine.model_version)}
        if op == "drain":
            self.engine.drain()
            idle = None
            if req.get("wait"):
                deadline = time.monotonic() \
                    + float(req.get("timeout") or self.default_timeout)
                while not self.engine.scheduler.idle \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
                idle = self.engine.scheduler.idle
            rep = {"draining": True,
                   "queue_depth": self.engine.scheduler.queue_depth}
            if idle is not None:
                rep["idle"] = bool(idle)
            return rep
        if op == "stats":
            return self.engine.stats()
        if op == "metrics":
            # Prometheus exposition over the whole process registry —
            # scrape point for the serving tier
            return _obs.prometheus_text()
        if op == "debug_dump":
            # full postmortem bundle on demand:
            # metrics + trace ring + flight rings + in-flight request
            # table, persisted to the server-side PADDLE_TPU_DEBUG_DIR
            # (never a wire-chosen path) and returned over the wire
            return _debug.dump_verb(req)
        if op == "generate":
            prompt = np.asarray(req["prompt"], np.int32)
            # serve_connection already opened a span rooted at the wire
            # trace id; this child span marks the frontend tier and the
            # engine.submit inside it stamps the id onto the request
            with _tracing.span("frontend.generate",
                               prompt_len=int(prompt.size)) as sp:
                try:
                    sp_params = SamplingParams.from_request(req)
                    seed = sp_params.seed
                    if seed is None and sp_params.temperature > 0 \
                            and rid:
                        # no client seed: key the Philox stream by the
                        # STABLE wire id (retries/failovers relay it)
                        seed = derive_seed(rid)
                    h = self.engine.submit(
                        prompt, int(req.get("max_new_tokens", 16)),
                        deadline=req.get("deadline"),
                        priority=int(req.get("priority", 1)),
                        tenant=str(req.get("tenant", "default")),
                        temperature=sp_params.temperature,
                        top_k=sp_params.top_k, top_p=sp_params.top_p,
                        seed=seed)
                except QueueFull as e:
                    sp.attrs["status"] = "rejected"
                    return {"status": "rejected", "error": str(e)}
                except ValueError as e:
                    sp.attrs["status"] = "error"
                    return {"status": "error", "error": str(e)}
                if req.get("stream"):
                    # generator reply: serve_connection pushes each
                    # yielded frame as F_STREAM, then the returned dict
                    # as the final (dedup-cached) reply
                    sp.attrs["status"] = "stream"
                    return self._stream_result(req, h)
                out = self._await_result(req, h)
                sp.attrs["status"] = out.get("status")
                return out

        raise ValueError(f"unknown op {op!r}")

    def _await_result(self, req: dict, h):
        timeout = float(req.get("timeout") or self.default_timeout)
        if not h.wait(timeout):
            return self._timeout_reply(h, timeout)
        return self._finished_reply(h)

    def _timeout_reply(self, h, timeout: float):
        # the reply gets dedup-cached, so the request must not
        # keep decoding tokens nobody can ever retrieve: cancel
        # it (frees slot+pages) and return the partial output.
        # cancel() can lose the race to completion — fall
        # through to the finished result in that case.
        if self.engine.cancel(h):
            return {"status": "timeout",
                    "tokens": np.asarray(h.generated, np.int32),
                    "error": f"not finished within {timeout}s; "
                             "request cancelled",
                    "trace_id": h.trace_id}
        return self._finished_reply(h)

    def _finished_reply(self, h):
        # trace_id rides every reply so callers (loadgen exemplars,
        # operators) can pull the assembled cross-process trace from
        # the telemetry collector by id
        if h.status == "error":
            return {"status": "error", "error": h.error or "failed",
                    "trace_id": h.trace_id}
        return {"status": h.status,
                "tokens": np.asarray(h.generated, np.int32),
                "prompt_len": int(h.prompt.size),
                "latency_ms": round((h.latency() or 0.0) * 1e3, 3),
                "trace_id": h.trace_id}

    def _stream_result(self, req: dict, h):
        """Push tokens as they decode, finish with the normal reply.
        The final frame's "tokens" is the authoritative full list —
        stream frames are incremental progress (TTFT/ITL on the wire,
        mid-generation stall detection for the router). The span opens
        at first next(), not at dispatch — a returned generator
        outlives the dispatch call, and the span must cover the
        stream's real duration and final status."""
        with _tracing.span("frontend.stream", request=h.id,
                           prompt_len=int(h.prompt.size)) as sp:
            out = yield from self._stream_body(req, h)
            sp.attrs["status"] = out.get("status")
            return out

    def _stream_body(self, req: dict, h):
        timeout = float(req.get("timeout") or self.default_timeout)
        deadline = time.monotonic() + timeout
        sent = 0
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._timeout_reply(h, timeout)
                toks, done = h.next_tokens(sent, timeout=remaining)
                if toks:
                    yield {"tokens": np.asarray(toks, np.int32),
                           "index": sent}
                    sent += len(toks)
                if done:
                    return self._finished_reply(h)
        finally:
            # GeneratorExit: the client connection died mid-stream —
            # nobody can ever fetch this request's reply (it is NOT in
            # the dedup cache yet), so stop burning decode steps on it
            if not h.done():
                self.engine.cancel(h)


class ServingClient:
    """Thin client over RpcClient (retry/deadline/dedup semantics).

    Thread-safe and truly concurrent over the multiplexed transport:
    calls and streamed generates from many threads interleave
    over the pooled channels (PADDLE_TPU_RPC_POOL_SIZE sockets,
    replies matched by request id), so one shared ServingClient no
    longer serializes callers — a long streamed generate does not
    head-of-line block a concurrent ping."""

    def __init__(self, endpoint: str, secret: str | None = None,
                 timeout: float | None = None):
        self._rpc = RpcClient(endpoint, secret=secret,
                              timeout=timeout if timeout is not None
                              else 150.0)

    def ping(self) -> bool:
        rep = self._rpc.call({"op": "ping"})
        return bool(rep.get("ok")) if isinstance(rep, dict) \
            else bool(rep)

    def ping_info(self) -> dict:
        """Full health/load probe: draining flag, queue depth, active
        slots, page occupancy (what the router's least-loaded dispatch
        and health state machine read)."""
        rep = self._rpc.call({"op": "ping"})
        return rep if isinstance(rep, dict) else {"ok": bool(rep)}

    def drain(self, wait: bool = False,
              timeout: float | None = None) -> dict:
        """Graceful removal: stop admitting, finish the queue.
        ``wait=True`` blocks until the server ran dry (reply carries
        "idle")."""
        req = {"op": "drain", "wait": bool(wait)}
        if timeout is not None:
            req["timeout"] = float(timeout)
        wire_t = (timeout or 120.0) + 30.0
        return self._rpc.call(req, timeout=wire_t, deadline=wire_t + 30)

    def stats(self) -> dict:
        return self._rpc.call({"op": "stats"})

    def adopt_version(self, version: int,
                      timeout: float = 120.0) -> dict:
        """Hot-swap the replica to published ``version`` (loaded from
        ITS configured publish root). Mutating + dedup-cached: a
        retried adopt replays the recorded reply, never a second
        device upload."""
        return self._rpc.call({"op": "adopt_version",
                               "version": int(version)},
                              timeout=timeout, deadline=timeout + 30)

    def metrics(self) -> str:
        """Prometheus text from the serving process's registry."""
        return self._rpc.call({"op": "metrics"})

    def debug_dump(self, write: bool = True) -> dict:
        """Pull a full postmortem bundle from a (healthy or wedged)
        server: metrics, trace ring, flight rings, env, in-flight
        requests. ``write=True`` also persists it server-side into the
        server's own PADDLE_TPU_DEBUG_DIR (the destination is never
        wire-controlled)."""
        return self._rpc.call({"op": "debug_dump",
                               "write": bool(write)})

    def generate(self, prompt, max_new_tokens: int = 16,
                 deadline: float | None = None,
                 timeout: float = 120.0, priority: int = 1,
                 tenant: str = "default", session: str | None = None,
                 stream: bool = False, on_token=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int | None = None) -> dict:
        """One generation round-trip. ``stream=True`` asks the server
        to push tokens as they decode; ``on_token(tokens, index)`` is
        called per pushed frame on this thread and delivers every token
        EXACTLY ONCE in order (a mid-stream transport retry re-streams
        from index 0 — the client forwards only the unseen tail, the
        same dedup the router's failover relay applies). The returned
        final reply's "tokens" is the authoritative full list (a
        dedup-hit retry replays no frames — on_token may see nothing).
        ``session`` is the router's affinity key (ignored by a bare
        ServingServer)."""
        req = {"op": "generate",
               "prompt": np.asarray(prompt, np.int32),
               "max_new_tokens": int(max_new_tokens),
               "deadline": deadline, "timeout": timeout,
               "priority": int(priority), "tenant": str(tenant)}
        # only non-default sampling knobs go on the wire (validated
        # here so a bad temperature fails client-side, not mid-stream)
        SamplingParams(temperature, top_k, top_p, seed).to_request(req)
        if session is not None:
            req["session"] = str(session)
        if not stream:
            return self._rpc.call(req, timeout=timeout + 30.0,
                                  deadline=timeout + 60.0)
        req["stream"] = True
        seen = 0

        def _on(frame):
            nonlocal seen
            if on_token is None or not isinstance(frame, dict) \
                    or frame.get("tokens") is None:
                return
            toks = [int(t) for t in
                    np.asarray(frame["tokens"]).ravel()]
            new = int(frame.get("index", 0)) + len(toks) - seen
            if new > 0:
                on_token(toks[len(toks) - new:], seen)
                seen += new

        # streamed: the per-attempt timeout bounds the INTER-FRAME gap,
        # the deadline bounds the whole call
        return self._rpc.call(req, timeout=timeout + 30.0,
                              deadline=timeout + 60.0, on_stream=_on)

    def close(self):
        self._rpc.close()
