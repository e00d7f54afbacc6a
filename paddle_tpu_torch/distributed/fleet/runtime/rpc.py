"""Fault-tolerant multiplexed RPC layer for the serving and PS tiers
(counterpart of ``paddle_tpu/distributed/fleet/runtime/rpc.py``: frames
are byte-identical for the same object, so either package's client
talks to the other's server).

A data-only wire format plus client retry and server dedup. Analog: the
brpc channel options (timeout_ms / max_retry / backoff) and the
correlation-id multiplexing of its single-connection-many-RPCs model,
re-expressed as a dependency-free protocol:

  frame   := header || body
  header  := magic u16 | ver u8 | flags u8 | req_id u64 | crc u32
             | body_len u64                      (24 bytes, little-endian)
  body    := skel_len u32 | skeleton(JSON) | segment*
  segment := dtype u8 | ndim u8 | dims i64*ndim | raw row-major bytes

The skeleton is plain JSON (dict/list/str/number/bool/null) where every
ndarray was replaced by {"__nd__": k}; segments carry the arrays in
order. Decoding therefore never evaluates attacker-controlled code —
`json.loads` plus `np.frombuffer` against a dtype whitelist — no
pickle on any receive path (a pickle reader bound beyond localhost is
remote code execution).

Integrity/auth:
  * crc32 over the body rejects corrupted frames (fault tolerance, not
    security — CRC is not a MAC).
  * optional shared-secret handshake: when PADDLE_PS_SECRET is set on
    the server, every connection must answer an HMAC-SHA256 challenge
    before the first request. Beyond that the network is trusted.

Multiplexing: every frame — request, reply, F_STREAM push,
F_CANCEL — carries its request id in the header, so ONE socket
interleaves many concurrent calls and replies may arrive out of order.
A channel runs a writer thread (draining a send queue) and a reader
thread (demuxing frames to per-call waiters by request id); callers
never touch the socket. `RpcClient` keeps a small per-endpoint channel
pool (PADDLE_TPU_RPC_POOL_SIZE) with a per-channel in-flight cap
(PADDLE_TPU_RPC_MAX_INFLIGHT); a streamed call no longer monopolizes a
connection. PADDLE_TPU_RPC_MUX=0 restores the legacy
one-call-per-channel discipline (same pool, exclusive channel per call,
classic copying reads) for A/B benchmarks.

Zero-copy receive: the mux reader lands each body in a pooled buffer
via ``recv_into`` and decodes ndarray segments as views into it — no
chunk-assembly copy. The buffer returns to the pool once no decoded
array references it (``BufferPool``). Transport-level copies are
counted on ``paddle_tpu_rpc_mux_bytes_copied_total`` (the mux path
copies only the header + JSON skeleton; the legacy path copies every
body byte), which is the proof the hot pull path stopped copying.

Corruption scope: under multiplexing a corrupt BODY on an intact header
poisons only its own request id — the reader has consumed exactly
body_len bytes, the stream stays framed, and concurrent calls on the
socket are untouched (the server answers that id with a retryable
``kind="wire"`` error frame; the client fails just that call). A
corrupt HEADER still desyncs the stream and kills the connection.

Client semantics (`RpcClient.call`):
  * per-request deadline + per-attempt timeout,
  * exponential backoff with jitter, bounded retries/reconnects,
  * a stable request id across retries; the server dedups mutating ops
    by id, so a retried gradient push is applied exactly once. Callers
    that own failover across SERVERS (the serving router) can pin the
    id themselves via ``req_id=`` so a replay on whichever replica —
    original or survivor — carries the same identity.

Server-push streaming: a dispatch function may return a GENERATOR.
`serve_connection` then sends every yielded object as an ``F_STREAM``
frame (same request id) and the generator's return value as the normal
final reply — which is what the dedup cache memoises, so a retried
streamed op is answered with the final frame only. Clients consume the
pushed frames via ``call(..., on_stream=fn)`` or ``call_stream``; the
per-attempt timeout bounds the INTER-FRAME gap per stream, which is how
a caller detects a server wedged mid-generation. A client that abandons
a stream sends ``F_CANCEL`` for that id; the server raises
GeneratorExit into the dispatch generator so whatever produced the
stream is cancelled — the connection itself survives (it is shared).
"""
from __future__ import annotations

import contextlib
import hmac
import hashlib
import itertools
import json
import os
import queue
import random
import socket
import struct
import sys
import threading
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ....observability import (flight as _flight, registry as _obs,
                               tracing as _tracing)
from .fault_injection import injector

__all__ = [
    "WireError", "PSAuthError", "PSRemoteError", "PSDeadlineError",
    "encode_body", "decode_body", "send_frame", "recv_frame",
    "TransportStats", "RpcClient", "DedupCache", "RpcServerState",
    "serve_connection", "PROTOCOL_VERSION", "TRACE_KEY", "F_STREAM",
    "F_CANCEL", "BufferPool",
]

PROTOCOL_VERSION = 1
_MAGIC = 0x7053                      # "Sp" — PS rpc

# transport telemetry on the process-wide registry. The skeleton may
# carry a `_trace_id` field (injected by RpcClient.call, stripped by
# serve_connection before dispatch) so one request is followable
# client -> server and frontend -> engine across processes.
TRACE_KEY = "_trace_id"
_CLIENT_EVENTS = _obs.counter(
    "paddle_tpu_rpc_client_events_total",
    "client transport events (requests/retries/timeouts/...)",
    ["event"])
_CLIENT_BYTES = _obs.counter(
    "paddle_tpu_rpc_client_bytes_total",
    "client wire bytes by direction", ["direction"])
_CLIENT_LATENCY = _obs.histogram(
    "paddle_tpu_rpc_client_latency_seconds",
    "successful call() round-trip latency incl. retries", ["op"])
_SERVER_REQS = _obs.counter(
    "paddle_tpu_rpc_server_requests_total",
    "requests received by serve_connection", ["op"])
_SERVER_ERRORS = _obs.counter(
    "paddle_tpu_rpc_server_errors_total",
    "dispatch failures answered with an error frame", ["op"])
_SERVER_DEDUP_HITS = _obs.counter(
    "paddle_tpu_rpc_server_dedup_hits_total",
    "mutating requests answered from the dedup cache (client retries)",
    ["op"])
# mux-transport telemetry: the in-flight/pool gauges size the
# channel fan-out, bytes-copied proves the zero-copy pull path, and the
# out-of-order counter proves replies genuinely interleave.
_MUX_INFLIGHT = _obs.gauge(
    "paddle_tpu_rpc_mux_inflight",
    "in-flight calls multiplexed across one client's channel pool",
    ["endpoint"])
_MUX_CHANNELS = _obs.gauge(
    "paddle_tpu_rpc_mux_channels",
    "open channels in a client's per-endpoint pool", ["endpoint"])
_MUX_BYTES_COPIED = _obs.counter(
    "paddle_tpu_rpc_mux_bytes_copied_total",
    "receive-path bytes memcpy'd by the transport (mux: header+skeleton"
    " only; legacy: every body byte is assembled through a copy)",
    ["path"])
_MUX_OUT_OF_ORDER = _obs.counter(
    "paddle_tpu_rpc_mux_out_of_order_total",
    "replies that completed a call that was not the oldest in flight "
    "on its channel")
_MUX_ORPHANS = _obs.counter(
    "paddle_tpu_rpc_mux_orphan_frames_total",
    "frames whose request id had no waiter (late reply after a timeout"
    " or an abandoned stream)")
_MUX_FRAME_ERRORS = _obs.counter(
    "paddle_tpu_rpc_mux_frame_errors_total",
    "body-local frame failures contained to one request id", ["side"])
_HDR = struct.Struct("<HBBQIQ")      # magic, ver, flags, req_id, crc, len
HEADER_SIZE = _HDR.size
F_ERROR = 1
F_HANDSHAKE = 2
F_STREAM = 4                         # server-push frame; more follow
F_CANCEL = 8                         # client abandons this request id
_MAX_BODY = 1 << 31                  # sanity bound on a length field

_ND_KEY = "__nd__"

# dtype whitelist: receiving anything else is a wire error, never an
# object/pickle dtype
_DTYPES = [np.dtype(s) for s in (
    "float32", "float64", "float16", "int64", "int32", "int16", "int8",
    "uint64", "uint32", "uint16", "uint8", "bool")]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}


class WireError(ConnectionError):
    """Malformed/corrupt frame — the connection is no longer trusted."""


class PSAuthError(RuntimeError):
    """Handshake failure. Not retryable."""


class PSRemoteError(RuntimeError):
    """The server dispatched the request and replied with an error."""


class PSDeadlineError(ConnectionError):
    """Retries/deadline exhausted without a successful round-trip."""


class _FrameError(Exception):
    """Body-local failure (bad crc / bad body) on an INTACT frame: the
    reader consumed exactly body_len bytes, so the stream is still
    framed and only this request id's call is poisoned."""

    def __init__(self, req_id: int, flags: int, msg: str):
        super().__init__(msg)
        self.req_id = req_id
        self.flags = flags


class _Cancelled(Exception):
    """Server-side: the client sent F_CANCEL (or died) mid-stream."""


# ---------------------------------------------------------------------------
# body codec: JSON skeleton + dtype/shape-tagged ndarray segments
# ---------------------------------------------------------------------------

def encode_body(obj) -> bytes:
    arrays: list[np.ndarray] = []

    def strip(o):
        if isinstance(o, np.ndarray):
            arrays.append(o)
            return {_ND_KEY: len(arrays) - 1}
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, dict):
            return {str(k): strip(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [strip(v) for v in o]
        return o

    skel = json.dumps(strip(obj)).encode("utf-8")
    parts = [struct.pack("<I", len(skel)), skel]
    for a in arrays:
        a = np.ascontiguousarray(a)
        code = _DTYPE_CODE.get(a.dtype)
        if code is None:
            raise TypeError(
                f"dtype {a.dtype} is not wire-safe (whitelist: "
                f"{[str(d) for d in _DTYPES]})")
        parts.append(struct.pack("<BB", code, a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
        parts.append(a.tobytes())
    return b"".join(parts)


def _decode_body_ex(buf):
    """Core decoder over any buffer-protocol object (bytes for the
    legacy path, a read-only memoryview of a pooled buffer for the mux
    path — the ndarray segments become VIEWS into it, no copy).

    Returns (obj, n_arrays, copied): `n_arrays` tells the caller
    whether the source buffer is now referenced by live views (it must
    stay leased), `copied` is the bytes memcpy'd here (the JSON
    skeleton — json.loads needs a bytes object)."""
    if len(buf) < 4:
        raise WireError("body too short")
    (skel_len,) = struct.unpack_from("<I", buf, 0)
    if 4 + skel_len > len(buf):
        raise WireError("skeleton length exceeds body")
    try:
        skel = json.loads(bytes(buf[4:4 + skel_len]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"bad skeleton: {e}") from None
    arrays: list[np.ndarray] = []
    off = 4 + skel_len
    while off < len(buf):
        if off + 2 > len(buf):
            raise WireError("truncated segment header")
        code, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        if code >= len(_DTYPES) or ndim > 16:
            raise WireError(f"bad segment tag ({code}, {ndim})")
        if off + 8 * ndim > len(buf):
            raise WireError("truncated segment dims")
        dims = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        if any(d < 0 for d in dims):
            raise WireError(f"negative dim {dims}")
        dt = _DTYPES[code]
        # python-int product: immune to the int64 overflow a hostile
        # dims vector could use to slip past the bounds check
        count = 1
        for d in dims:
            count *= d
        nbytes = count * dt.itemsize if ndim else dt.itemsize
        if nbytes > len(buf) - off:
            raise WireError("segment data exceeds body")
        try:
            arr = np.frombuffer(buf, dt, count=nbytes // dt.itemsize,
                                offset=off).reshape(dims)
        except ValueError as e:
            raise WireError(f"bad segment geometry: {e}") from None
        arrays.append(arr)
        off += nbytes

    def build(o):
        if isinstance(o, dict):
            if set(o) == {_ND_KEY} and isinstance(o[_ND_KEY], int):
                k = o[_ND_KEY]
                if not 0 <= k < len(arrays):
                    raise WireError(f"dangling array ref {k}")
                return arrays[k]
            return {k: build(v) for k, v in o.items()}
        if isinstance(o, list):
            return [build(v) for v in o]
        return o

    return build(skel), len(arrays), 4 + skel_len


def decode_body(buf):
    obj, _n, _copied = _decode_body_ex(buf)
    return obj


# ---------------------------------------------------------------------------
# pooled receive buffers (zero-copy mux read path)
# ---------------------------------------------------------------------------

class BufferPool:
    """Size-classed pool of receive buffers for `recv_into`.

    A buffer whose decoded frame contained ndarray segments is LEASED:
    the arrays are views into it, so it cannot be reused until every
    view is gone. numpy keeps the underlying buffer referenced through
    the view chain, so a leased buffer is reclaimable exactly when its
    refcount drops back to the pool's own references — checked with
    `sys.getrefcount` on each acquire (pure CPython refcounting; no GC
    or finalizer dependency, so reuse can never race a live view)."""

    _MIN = 1 << 12

    def __init__(self, max_bytes: int = 64 * (1 << 20),
                 max_leases: int = 512):
        self.max_bytes = max_bytes
        self.max_leases = max_leases
        self._lock = threading.Lock()
        self._free: dict[int, list[bytearray]] = {}
        self._free_bytes = 0
        self._leased: list[bytearray] = []
        self.hits = 0
        self.misses = 0

    @classmethod
    def _cls_size(cls, n: int) -> int:
        size = cls._MIN
        while size < n:
            size <<= 1
        return size

    def _reclaim_locked(self):
        still = []
        for buf in self._leased:
            # refs while scanning: the list entry, the loop variable,
            # and getrefcount's argument == 3 when no view is left
            if sys.getrefcount(buf) <= 3:
                self._stash_locked(buf)
            else:
                still.append(buf)
        self._leased = still

    def _stash_locked(self, buf: bytearray):
        if self._free_bytes + len(buf) <= self.max_bytes:
            self._free.setdefault(len(buf), []).append(buf)
            self._free_bytes += len(buf)

    def acquire(self, n: int) -> bytearray:
        """A bytearray of some size class >= n (slice a memoryview to
        the exact length)."""
        size = self._cls_size(n)
        with self._lock:
            self._reclaim_locked()
            bucket = self._free.get(size)
            if bucket:
                self.hits += 1
                self._free_bytes -= size
                return bucket.pop()
            self.misses += 1
        return bytearray(size)

    def release(self, buf: bytearray):
        """Return a buffer no live view references (frames that decoded
        to pure-JSON bodies release immediately)."""
        with self._lock:
            self._stash_locked(buf)

    def lease(self, buf: bytearray):
        """Track a buffer still referenced by decoded array views; it
        rejoins the free list once they are all gone."""
        with self._lock:
            if len(self._leased) < self.max_leases:
                self._leased.append(buf)
            # else: forget it — plain GC takes it when the views die

    def stats(self) -> dict:
        with self._lock:
            return {"free_bytes": self._free_bytes,
                    "leased": len(self._leased),
                    "hits": self.hits, "misses": self.misses}


# one process-wide pool shared by every mux reader (client channels and
# server connections): replies and pushes recycle the same few hot
# size classes
_BUFFER_POOL = BufferPool()


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _hard_close(sock: socket.socket):
    """Tear a connection down so the PEER and every local thread see it
    NOW. ``close()`` alone is not enough on a multiplexed socket: a
    thread blocked in ``recv`` on the same socket pins the open file
    description, so the kernel keeps the connection alive and no FIN
    goes out until that recv returns — the other end then burns its
    full per-attempt timeout staring at a healthy-looking silent
    channel. ``shutdown`` acts on the file description itself: it sends
    the FIN and wakes blocked readers immediately."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _build_frame(obj, req_id: int = 0, flags: int = 0) -> bytes:
    body = encode_body(obj)
    return _HDR.pack(_MAGIC, PROTOCOL_VERSION, flags, req_id,
                     zlib.crc32(body), len(body)) + body


def send_frame(sock: socket.socket, obj, req_id: int = 0,
               flags: int = 0, side: str | None = None) -> int:
    frame = _build_frame(obj, req_id, flags)
    inj = injector()
    if inj.active:
        frame, action = inj.mangle(frame, HEADER_SIZE, side,
                                   req_id=req_id)
        if action == "drop":
            _hard_close(sock)
            raise ConnectionError("fault-injected frame drop")
        if action == "truncate":
            try:
                sock.sendall(frame[:max(len(frame) // 2, 1)])
            finally:
                _hard_close(sock)
            raise ConnectionError("fault-injected frame truncation")
        if action == "skip":
            return 0        # granular single-frame drop: frame vanishes
    sock.sendall(frame)
    return len(frame)


def _recvn(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket, side: str | None = None):
    """Blocking copying read (handshakes, legacy channels, direct
    protocol tests). Returns (obj, req_id, flags, frame_bytes). Raises
    WireError on a frame that fails validation — the stream is
    desynced, the caller must close the connection."""
    hdr = _recvn(sock, HEADER_SIZE)
    magic, ver, flags, req_id, crc, body_len = _HDR.unpack(hdr)
    if magic != _MAGIC:
        raise WireError(f"bad magic 0x{magic:04x}")
    if ver != PROTOCOL_VERSION:
        raise WireError(f"protocol version {ver} != {PROTOCOL_VERSION}")
    if body_len > _MAX_BODY:
        raise WireError(f"body length {body_len} exceeds bound")
    body = _recvn(sock, body_len)
    if zlib.crc32(body) != crc:
        raise WireError("crc mismatch (corrupt frame)")
    # the bytearray-chunk assembly + bytes() above copied the whole body
    _MUX_BYTES_COPIED.labels(path="legacy").inc(HEADER_SIZE + body_len)
    return decode_body(body), req_id, flags, HEADER_SIZE + body_len


def _recv_into(sock: socket.socket, mv: memoryview):
    got = 0
    while got < len(mv):
        n = sock.recv_into(mv[got:])
        if not n:
            raise ConnectionError("peer closed")
        got += n


def _read_frame_mux(sock: socket.socket, pool: BufferPool,
                    hdr_buf: bytearray):
    """Zero-copy frame read: body lands in a pooled buffer via
    recv_into; ndarray segments decode as views into it (the buffer is
    leased until they die). Returns (obj, req_id, flags, nbytes).

    Raises WireError/ConnectionError for stream-fatal failures (bad
    header, EOF) and _FrameError for body-local ones (bad crc, bad
    body) — the frame was fully consumed, the stream is still synced,
    only that request id is poisoned."""
    _recv_into(sock, memoryview(hdr_buf))
    magic, ver, flags, req_id, crc, body_len = _HDR.unpack(hdr_buf)
    if magic != _MAGIC:
        raise WireError(f"bad magic 0x{magic:04x}")
    if ver != PROTOCOL_VERSION:
        raise WireError(f"protocol version {ver} != {PROTOCOL_VERSION}")
    if body_len > _MAX_BODY:
        raise WireError(f"body length {body_len} exceeds bound")
    buf = pool.acquire(body_len)
    view = memoryview(buf)[:body_len]
    _recv_into(sock, view)
    if zlib.crc32(view) != crc:
        pool.release(buf)
        raise _FrameError(req_id, flags, "crc mismatch (corrupt frame)")
    try:
        obj, n_arrays, copied = _decode_body_ex(view.toreadonly())
    except WireError as e:
        pool.release(buf)
        raise _FrameError(req_id, flags, str(e)) from None
    if n_arrays:
        pool.lease(buf)
    else:
        pool.release(buf)
    _MUX_BYTES_COPIED.labels(path="mux").inc(HEADER_SIZE + copied)
    return obj, req_id, flags, HEADER_SIZE + body_len


def _send_mux(sock: socket.socket, frame: bytes, side: str,
              req_id: int, requeue) -> int:
    """Writer-thread send with fault injection. Granular single-frame
    faults (by request id) consume/delay ONE frame without touching the
    channel; the legacy probabilistic knobs keep their connection-death
    semantics. Returns bytes sent; raises ConnectionError when the
    channel must die."""
    inj = injector()
    if inj.active:
        act = inj.frame_fault(req_id, side)
        if act is not None:
            kind, arg = act
            if kind == "drop":
                return 0                 # this frame silently vanishes
            if kind == "delay":
                threading.Timer(arg, requeue,
                                args=(frame, req_id)).start()
                return 0
            if kind == "corrupt" and len(frame) > HEADER_SIZE:
                buf = bytearray(frame)
                buf[HEADER_SIZE] ^= 0xFF
                frame = bytes(buf)
        frame, action = inj.mangle(frame, HEADER_SIZE, side)
        if action == "drop":
            # _hard_close, not close(): the connection's reader thread
            # is blocked in recv on this socket — a bare close would
            # leave the kernel connection up and the peer waiting out
            # its whole timeout on a silent channel
            _hard_close(sock)
            raise ConnectionError("fault-injected frame drop")
        if action == "truncate":
            try:
                sock.sendall(frame[:max(len(frame) // 2, 1)])
            finally:
                _hard_close(sock)
            raise ConnectionError("fault-injected frame truncation")
        if action == "skip":
            return 0
    sock.sendall(frame)
    return len(frame)


# ---------------------------------------------------------------------------
# handshake: protocol version + optional HMAC shared secret
# ---------------------------------------------------------------------------

def _mac(secret: str, nonce: str) -> str:
    return hmac.new(secret.encode(), nonce.encode(),
                    hashlib.sha256).hexdigest()


def server_handshake(sock: socket.socket, secret: str | None):
    nonce = os.urandom(16).hex() if secret else None
    send_frame(sock, {"ver": PROTOCOL_VERSION, "nonce": nonce},
               flags=F_HANDSHAKE)
    reply, _rid, flags, _n = recv_frame(sock)
    if not flags & F_HANDSHAKE:
        raise WireError("expected handshake reply")
    if secret is not None:
        mac = reply.get("mac") if isinstance(reply, dict) else None
        if not (isinstance(mac, str)
                and hmac.compare_digest(mac, _mac(secret, nonce))):
            send_frame(sock, {"error": "authentication failed",
                              "kind": "auth"}, flags=F_ERROR)
            raise PSAuthError("client failed the PADDLE_PS_SECRET "
                              "challenge")
    send_frame(sock, {"ok": True}, flags=F_HANDSHAKE)


def client_handshake(sock: socket.socket, secret: str | None):
    hello, _rid, flags, _n = recv_frame(sock)
    if not flags & F_HANDSHAKE or not isinstance(hello, dict):
        raise WireError("expected handshake hello")
    if hello.get("ver") != PROTOCOL_VERSION:
        raise PSAuthError(
            f"server protocol version {hello.get('ver')} != "
            f"{PROTOCOL_VERSION}")
    nonce = hello.get("nonce")
    if nonce is not None and secret is None:
        raise PSAuthError(
            "server requires a shared secret — set PADDLE_PS_SECRET")
    mac = _mac(secret, nonce) if nonce is not None else None
    send_frame(sock, {"mac": mac}, flags=F_HANDSHAKE)
    ok, _rid, flags, _n = recv_frame(sock)
    if flags & F_ERROR:
        raise PSAuthError(str(ok.get("error", "handshake rejected"))
                          if isinstance(ok, dict) else "rejected")
    if not flags & F_HANDSHAKE:
        raise WireError("expected handshake ack")


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class TransportStats:
    """Thread-safe transport counters, shared across a client's
    per-endpoint connections (tests/benchmarks read these)."""

    _FIELDS = ("requests", "retries", "reconnects", "timeouts",
               "corrupt_frames", "remote_errors", "deadline_exceeded")

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_out = 0
        self.bytes_in = 0
        for f in self._FIELDS:
            setattr(self, f, 0)

    def add(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        # mirror into the process-wide registry (PSClient.stats keeps
        # its exact per-client surface; /metrics shows the aggregate)
        _CLIENT_EVENTS.labels(event=field).inc(n)

    def add_bytes(self, n_out: int, n_in: int):
        with self._lock:
            self.bytes_out += n_out
            self.bytes_in += n_in
        _CLIENT_BYTES.labels(direction="out").inc(n_out)
        _CLIENT_BYTES.labels(direction="in").inc(n_in)

    def as_dict(self) -> dict:
        with self._lock:
            d = {f: getattr(self, f) for f in self._FIELDS}
            d["bytes_out"] = self.bytes_out
            d["bytes_in"] = self.bytes_in
            return d


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


_WAITER_DEAD = "dead"      # channel died; payload = exception
_WAITER_REPLY = "reply"    # final reply;  payload = decoded object
_WAITER_STREAM = "stream"  # F_STREAM push; payload = decoded object
_WAITER_ERRFRAME = "err"   # F_ERROR reply; payload = decoded object
_WAITER_WIRE = "wire"      # body-local corruption; payload = message


class _Channel:
    """One multiplexed connection: a writer thread drains a send queue,
    a reader thread demuxes incoming frames to per-call waiter queues
    by request id. Neither the caller nor any lock ever touches the
    socket directly, so many calls interleave on one socket and a
    reply completes whichever call it belongs to — in any order.

    ``zero_copy=False`` (legacy A/B mode) reads with the classic
    copying `recv_frame` and keeps the one-call corruption semantics (a bad
    frame kills the connection)."""

    def __init__(self, client: "RpcClient", connect_timeout: float,
                 zero_copy: bool = True):
        self.client = client
        self.endpoint = client.endpoint
        self.zero_copy = zero_copy
        self.dead = False
        self.inflight = 0            # guarded by client._pool_cond
        self.last_rx = time.monotonic()
        self._wlock = threading.Lock()   # waiter tables only — no IO
        self._waiters: dict[int, queue.SimpleQueue] = {}
        self._order: dict[int, None] = {}
        self._sendq: queue.SimpleQueue = queue.SimpleQueue()
        host, port = self.endpoint.rsplit(":", 1)
        s = socket.create_connection((host, int(port)),
                                     timeout=connect_timeout)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(connect_timeout)
            client_handshake(s, client.secret)
            # blocking from here on: per-call timeouts live at the
            # waiter queues; a wedged channel is killed by the caller
            # when last_rx stops advancing
            s.settimeout(None)
        except BaseException:
            _hard_close(s)
            raise
        self.sock = s
        threading.Thread(target=self._writer, daemon=True,
                         name=f"rpc-mux-w-{self.endpoint}").start()
        threading.Thread(target=self._reader, daemon=True,
                         name=f"rpc-mux-r-{self.endpoint}").start()

    # -- caller API -----------------------------------------------------
    def register(self, req_id: int) -> queue.SimpleQueue:
        q: queue.SimpleQueue = queue.SimpleQueue()
        with self._wlock:
            if self.dead:
                raise ConnectionError("mux channel is closed")
            self._waiters[req_id] = q
            self._order[req_id] = None
        return q

    def deregister(self, req_id: int):
        with self._wlock:
            self._waiters.pop(req_id, None)
            self._order.pop(req_id, None)

    def send(self, frame: bytes, req_id: int):
        if self.dead:
            raise ConnectionError("mux channel is closed")
        self._sendq.put((frame, req_id))

    def close(self):
        self._kill(ConnectionError("mux channel closed"))

    # -- threads --------------------------------------------------------
    def _requeue(self, frame: bytes, req_id: int):
        # a fault-delayed frame re-enters the queue; later frames have
        # already overtaken it (that is the point of the fault)
        if not self.dead:
            self._sendq.put((frame, req_id))

    def _writer(self):
        while True:
            item = self._sendq.get()
            if item is None:
                return
            frame, rid = item
            try:
                n = _send_mux(self.sock, frame, "client", rid,
                              self._requeue)
            except Exception as e:
                self._kill(e)
                return
            if n:
                self.client.stats.add_bytes(n, 0)

    def _reader(self):
        hdr = bytearray(HEADER_SIZE)
        try:
            while True:
                if self.zero_copy:
                    try:
                        obj, rid, flags, n = _read_frame_mux(
                            self.sock, self.client.pool, hdr)
                    except _FrameError as fe:
                        # intact frame, corrupt body: fail ONLY the
                        # call it belongs to; the channel lives on
                        self.last_rx = time.monotonic()
                        _MUX_FRAME_ERRORS.labels(side="client").inc()
                        self._deliver(fe.req_id, (_WAITER_WIRE,
                                                  str(fe)))
                        continue
                else:
                    obj, rid, flags, n = recv_frame(self.sock,
                                                    side="client")
                self.last_rx = time.monotonic()
                self.client.stats.add_bytes(0, n)
                if flags & F_STREAM:
                    self._deliver(rid, (_WAITER_STREAM, obj))
                elif flags & F_ERROR:
                    self._deliver(rid, (_WAITER_ERRFRAME, obj))
                else:
                    self._note_completion_order(rid)
                    self._deliver(rid, (_WAITER_REPLY, obj))
        except Exception as e:
            self._kill(e)

    def _note_completion_order(self, rid: int):
        with self._wlock:
            if rid in self._order and next(iter(self._order)) != rid:
                out_of_order = True
            else:
                out_of_order = False
        if out_of_order:
            _MUX_OUT_OF_ORDER.inc()

    def _deliver(self, rid: int, event):
        with self._wlock:
            q = self._waiters.get(rid)
        if q is None:
            _MUX_ORPHANS.inc()
        else:
            q.put(event)

    def _kill(self, exc: Exception):
        with self._wlock:
            if self.dead:
                return
            self.dead = True
            waiters = list(self._waiters.values())
            self._waiters.clear()
            self._order.clear()
        for q in waiters:
            q.put((_WAITER_DEAD, exc))
        # _hard_close so the reader thread (blocked in recv on this
        # socket) wakes and the server sees the FIN immediately
        _hard_close(self.sock)
        self._sendq.put(None)
        self.client._on_channel_death(self)


class RpcClient:
    """One endpoint's fault-tolerant multiplexed channel pool: lazy
    connect + handshake, per-request deadline, exponential backoff with
    jitter, bounded retries, and stable request ids for server-side
    dedup. Safe for concurrent use from many threads — calls (including
    streams) interleave over the pooled channels."""

    def __init__(self, endpoint: str, stats: TransportStats | None = None,
                 secret: str | None = None,
                 timeout: float | None = None,
                 deadline: float | None = None,
                 max_retries: int | None = None,
                 backoff: float | None = None,
                 backoff_max: float = 2.0,
                 pool_size: int | None = None,
                 max_inflight: int | None = None,
                 mux: bool | None = None):
        self.endpoint = endpoint
        self.stats = stats if stats is not None else TransportStats()
        self.secret = secret if secret is not None \
            else os.environ.get("PADDLE_PS_SECRET")
        self.timeout = timeout if timeout is not None \
            else _env_float("PADDLE_PS_TIMEOUT", 60.0)
        self.deadline = deadline if deadline is not None \
            else _env_float("PADDLE_PS_DEADLINE", 600.0)
        self.max_retries = max_retries if max_retries is not None \
            else int(_env_float("PADDLE_PS_RETRIES", 64))
        self.backoff = backoff if backoff is not None \
            else _env_float("PADDLE_PS_BACKOFF", 0.05)
        self.backoff_max = backoff_max
        self.pool_size = pool_size if pool_size is not None \
            else max(1, int(_env_float("PADDLE_TPU_RPC_POOL_SIZE", 2)))
        self.max_inflight = max_inflight if max_inflight is not None \
            else max(1, int(_env_float("PADDLE_TPU_RPC_MAX_INFLIGHT",
                                       128)))
        if mux is None:
            mux = os.environ.get("PADDLE_TPU_RPC_MUX", "1") \
                not in ("0", "false", "no")
        self.mux = bool(mux)
        self.pool = _BUFFER_POOL
        self._pool_cond = threading.Condition()
        self._channels: list[_Channel] = []
        self._connecting = 0
        self._closed = False
        self._ever_connected = False
        self._had_loss = False
        # request ids stay unique across client restarts of THIS process
        # but not across client processes — a 32-bit random token
        # namespaces the 32-bit sequence
        self._token = int.from_bytes(os.urandom(4), "little")
        self._seq = itertools.count(1)

    def _next_id(self) -> int:
        return (self._token << 32) | (next(self._seq) & 0xFFFFFFFF)

    # -- channel pool ---------------------------------------------------
    def _set_gauges_locked(self):
        _MUX_CHANNELS.labels(endpoint=self.endpoint).set(
            len(self._channels))
        _MUX_INFLIGHT.labels(endpoint=self.endpoint).set(
            sum(c.inflight for c in self._channels))

    def _acquire_channel(self, wait_timeout: float,
                         exclusive: bool) -> _Channel:
        """A live channel with a free call slot. ``exclusive`` (legacy
        one-call-per-channel mode) reserves the whole channel. Blocks
        up to wait_timeout when the pool is saturated; connects a new
        channel (outside any lock) while the pool is below size."""
        deadline_ts = time.monotonic() + wait_timeout
        with self._pool_cond:
            while True:
                if self._closed:
                    raise ConnectionError("client closed")
                if any(c.dead for c in self._channels):
                    self._channels = [c for c in self._channels
                                      if not c.dead]
                cap = 1 if exclusive else self.max_inflight
                live = [c for c in self._channels if c.inflight < cap]
                if live:
                    ch = min(live, key=lambda c: c.inflight)
                    ch.inflight += 1
                    self._set_gauges_locked()
                    return ch
                if len(self._channels) + self._connecting \
                        < self.pool_size:
                    self._connecting += 1
                    break
                left = deadline_ts - time.monotonic()
                if left <= 0:
                    raise socket.timeout(
                        f"{self.endpoint}: all {self.pool_size} "
                        f"channel(s) at capacity")
                self._pool_cond.wait(left)
        # connect OUTSIDE the pool lock: a slow handshake must not
        # stall calls that could ride an existing channel
        try:
            ch = _Channel(self, min(5.0, max(wait_timeout, 0.1)),
                          zero_copy=self.mux)
        except BaseException:
            with self._pool_cond:
                self._connecting -= 1
                self._pool_cond.notify_all()
            raise
        with self._pool_cond:
            self._connecting -= 1
            if self._closed:
                self._pool_cond.notify_all()
                ch_dead = ch
            else:
                if self._ever_connected and self._had_loss:
                    self.stats.add("reconnects")
                    self._had_loss = False
                self._ever_connected = True
                ch.inflight = 1
                self._channels.append(ch)
                self._set_gauges_locked()
                self._pool_cond.notify_all()
                return ch
        ch_dead.close()
        raise ConnectionError("client closed")

    def _release_channel(self, ch: _Channel):
        with self._pool_cond:
            ch.inflight = max(0, ch.inflight - 1)
            self._set_gauges_locked()
            self._pool_cond.notify_all()

    def _on_channel_death(self, ch: _Channel):
        with self._pool_cond:
            self._had_loss = True
            if ch in self._channels:
                self._channels.remove(ch)
            self._set_gauges_locked()
            self._pool_cond.notify_all()

    def _drop(self):
        """Close every pooled channel (tests / server-restart paths);
        the next call reconnects."""
        with self._pool_cond:
            chans = list(self._channels)
            self._channels = []
            self._had_loss = True
            self._set_gauges_locked()
            self._pool_cond.notify_all()
        for c in chans:
            c.close()

    def close(self):
        with self._pool_cond:
            self._closed = True
        self._drop()
        for m in (_MUX_CHANNELS, _MUX_INFLIGHT):
            m.remove_matching(endpoint=self.endpoint)

    # -- calls ----------------------------------------------------------
    def call(self, req, timeout: float | None = None,
             deadline: float | None = None, on_stream=None,
             req_id: int | None = None,
             max_retries: int | None = None):
        """One request/reply round-trip; retried with the same request
        id until success, the deadline, or the retry bound. The span's
        trace id rides in the skeleton (TRACE_KEY) so the server side
        of this call joins the same trace.

        ``on_stream`` receives every F_STREAM frame the server pushes
        before the final reply (streamed ops); the per-attempt timeout
        then bounds the INTER-FRAME gap, not the whole call. Pushed
        frames are advisory progress — on a retry the final reply is
        the authoritative result (a dedup hit replays no stream
        frames). ``req_id`` pins the wire request id (serving-router
        failover: the SAME id must ride the replay on a surviving
        replica so a later retry against the original still dedups).
        ``max_retries`` overrides the client-wide bound per call
        (health probes want fail-fast pings on a shared channel)."""
        op = req.get("op") if isinstance(req, dict) else None
        with _tracing.span("rpc.client", op=op or "?",
                           endpoint=self.endpoint) as sp:
            if isinstance(req, dict) and TRACE_KEY not in req:
                req = {**req, TRACE_KEY: sp.trace_id}
            t_call = time.monotonic()
            try:
                rep = self._call_inner(req, timeout, deadline,
                                       on_stream=on_stream,
                                       req_id=req_id,
                                       max_retries=max_retries)
            except Exception as e:
                _flight.record("rpc", "client_error",
                               trace_id=sp.trace_id, op=op or "?",
                               endpoint=self.endpoint,
                               error=f"{type(e).__name__}: {e}")
                raise
            dt = time.monotonic() - t_call
            _CLIENT_LATENCY.labels(op=op or "?").observe(dt)
            _flight.record("rpc", "client_call", trace_id=sp.trace_id,
                           op=op or "?", endpoint=self.endpoint,
                           seconds=round(dt, 6))
            return rep

    def _handle_error_frame(self, rep):
        """Map an F_ERROR reply to its exception. ``kind="wire"`` means
        the SERVER saw a corrupt body for our id — retryable (raise
        WireError), and crucially only for this call."""
        msg = rep.get("error", "remote error") \
            if isinstance(rep, dict) else str(rep)
        kind = rep.get("kind") if isinstance(rep, dict) else None
        if kind == "auth":
            self.stats.add("remote_errors")
            raise PSAuthError(msg)
        if kind == "wire":
            raise WireError(msg)
        self.stats.add("remote_errors")
        raise PSRemoteError(msg)

    def _call_inner(self, req, timeout, deadline, on_stream=None,
                    req_id=None, max_retries=None):
        per_attempt = timeout if timeout is not None else self.timeout
        deadline_ts = time.monotonic() + (
            deadline if deadline is not None else self.deadline)
        retry_bound = max_retries if max_retries is not None \
            else self.max_retries
        attempt = 0
        last: Exception | None = None
        frame: bytes | None = None
        self.stats.add("requests")
        while True:
            remaining = deadline_ts - time.monotonic()
            if remaining <= 0 or attempt > retry_bound:
                self.stats.add("deadline_exceeded")
                raise PSDeadlineError(
                    f"PS request to {self.endpoint} failed after "
                    f"{attempt} attempt(s): {last}") from last
            ch: _Channel | None = None
            try:
                ch = self._acquire_channel(
                    min(per_attempt, max(remaining, 0.1)),
                    exclusive=not self.mux)
                if req_id is None:
                    req_id = self._next_id()
                if frame is None:
                    frame = _build_frame(req, req_id, 0)
                waiter = ch.register(req_id)
                try:
                    t_progress = time.monotonic()
                    ch.send(frame, req_id)
                    while True:
                        gap = min(per_attempt,
                                  max(deadline_ts - time.monotonic(),
                                      0.001))
                        try:
                            kind, payload = waiter.get(timeout=gap)
                        except queue.Empty:
                            if not ch.dead \
                                    and ch.last_rx < t_progress:
                                # the whole channel is silent, not just
                                # this call: peer wedged/dead — kill it
                                # so every caller fails over/reconnects
                                ch.close()
                            raise socket.timeout(
                                f"no frame for {gap:.1f}s") from None
                        if kind == _WAITER_STREAM:
                            t_progress = time.monotonic()
                            if on_stream is not None:
                                on_stream(payload)
                            continue
                        if kind == _WAITER_REPLY:
                            return payload
                        if kind == _WAITER_ERRFRAME:
                            self._handle_error_frame(payload)
                        if kind == _WAITER_WIRE:
                            raise WireError(payload)
                        if kind == _WAITER_DEAD:
                            raise payload if isinstance(
                                payload, Exception) \
                                else ConnectionError(str(payload))
                finally:
                    ch.deregister(req_id)
            except (PSAuthError, PSRemoteError):
                raise
            except WireError as e:
                last = e
                self.stats.add("corrupt_frames")
            except socket.timeout as e:
                last = e
                self.stats.add("timeouts")
            except (ConnectionError, OSError) as e:
                last = e
            finally:
                if ch is not None:
                    self._release_channel(ch)
            self.stats.add("retries")
            attempt += 1
            pause = min(self.backoff * (2 ** (attempt - 1)),
                        self.backoff_max)
            time.sleep(pause * (0.5 + random.random()))

    def call_stream(self, req, req_id: int | None = None,
                    timeout: float | None = None,
                    stream_timeout: float | None = None):
        """Single-attempt streaming call: a GENERATOR yielding each
        F_STREAM frame the server pushes, returning the final reply as
        its StopIteration value. No internal retry — the caller owns
        failover (the serving router replays on a different replica
        with the SAME ``req_id`` so dedup still holds).

        ``timeout`` bounds the wait for the FIRST frame (queueing +
        prefill happen before any token); ``stream_timeout`` bounds
        every later INTER-FRAME gap — a replica wedged mid-generation
        surfaces as socket.timeout here, which is the router's
        mid-stream stall signal. Transport errors propagate raw.

        Under multiplexing many streams (and calls) share the channel;
        abandoning the generator sends F_CANCEL for this id, which the
        server turns into GeneratorExit inside its dispatch generator —
        the CONNECTION survives. In legacy mode (mux=False) the stream
        still owns its channel exclusively for its lifetime."""
        op = req.get("op") if isinstance(req, dict) else None
        first_t = timeout if timeout is not None else self.timeout
        gap_t = stream_timeout if stream_timeout is not None else first_t
        with _tracing.span("rpc.client_stream", op=op or "?",
                           endpoint=self.endpoint) as sp:
            if isinstance(req, dict) and TRACE_KEY not in req:
                req = {**req, TRACE_KEY: sp.trace_id}
            self.stats.add("requests")
            rid = req_id if req_id is not None else self._next_id()
            ch = self._acquire_channel(first_t,
                                       exclusive=not self.mux)
            done = False
            try:
                waiter = ch.register(rid)
                try:
                    t_progress = time.monotonic()
                    ch.send(_build_frame(req, rid, 0), rid)
                    cur_t = first_t
                    while True:
                        try:
                            kind, payload = waiter.get(timeout=cur_t)
                        except queue.Empty:
                            self.stats.add("timeouts")
                            if not ch.dead \
                                    and ch.last_rx < t_progress:
                                ch.close()
                            raise socket.timeout(
                                f"stream stalled ({cur_t:.1f}s)") \
                                from None
                        t_progress = time.monotonic()
                        if kind == _WAITER_STREAM:
                            cur_t = gap_t
                            yield payload
                            continue
                        if kind == _WAITER_REPLY:
                            done = True
                            return payload
                        if kind == _WAITER_ERRFRAME:
                            self._handle_error_frame(payload)
                        if kind == _WAITER_WIRE:
                            self.stats.add("corrupt_frames")
                            raise WireError(payload)
                        if kind == _WAITER_DEAD:
                            raise payload if isinstance(
                                payload, Exception) \
                                else ConnectionError(str(payload))
                finally:
                    ch.deregister(rid)
                    if not done and not ch.dead:
                        # abandoned or failed mid-stream: tell the
                        # server to cancel whatever feeds this id; the
                        # shared channel itself stays healthy
                        with contextlib.suppress(Exception):
                            ch.send(_build_frame({}, rid, F_CANCEL),
                                    rid)
            finally:
                self._release_channel(ch)


# ---------------------------------------------------------------------------
# server-side connection loop: handshake + dedup + error replies
# ---------------------------------------------------------------------------

_FRESH = object()
_NULL_SCOPE = contextlib.nullcontext()


def _reply_nbytes(obj) -> int:
    """Rough retained size of a cached reply (arrays dominate)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes + 64
    if isinstance(obj, dict):
        return 64 + sum(_reply_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return 64 + sum(_reply_nbytes(v) for v in obj)
    return 64


class DedupCache:
    """Request-id -> reply memo for mutating ops (exactly-once across
    client retries). `begin` parks duplicate ids that race an in-flight
    original; entries are evicted FIFO past `capacity` entries or
    `max_bytes` of retained reply payload (a dense-gradient tier caches
    gradient-bundle replies — an entry-count bound alone would retain
    gigabytes)."""

    def __init__(self, capacity: int = 65536,
                 max_bytes: int = 256 * (1 << 20)):
        self.capacity = capacity
        self.max_bytes = max_bytes
        self._cond = threading.Condition()
        self._done: dict[int, object] = {}
        self._order: list[int] = []
        self._bytes = 0
        # newest committed req_id per client token (req_id >> 32): a
        # client serializes its calls, so only its LATEST request can
        # be mid-retry — protecting that one entry per client from
        # eviction closes the evicted-while-retrying double-apply
        # window at O(#clients) extra retention. The token set itself
        # is FIFO-bounded (first-seen order) so weeks of client churn
        # cannot pin unbounded replies; an expelled token's entry just
        # becomes normally evictable again.
        self._newest: dict[int, int] = {}
        self._token_order: list[int] = []
        self.token_capacity = 4096
        self._inflight: set[int] = set()

    def begin(self, req_id: int):
        """Returns the cached reply for a duplicate, or _FRESH (and
        marks the id in-flight) for a first arrival."""
        with self._cond:
            while True:
                if req_id in self._done:
                    return self._done[req_id]
                if req_id not in self._inflight:
                    self._inflight.add(req_id)
                    return _FRESH
                if not self._cond.wait(timeout=600):
                    raise TimeoutError(
                        f"duplicate request {req_id:#x} stuck behind an "
                        f"in-flight original")

    def commit(self, req_id: int, reply):
        with self._cond:
            self._inflight.discard(req_id)
            if req_id not in self._done:
                self._done[req_id] = reply
                self._order.append(req_id)
                self._bytes += _reply_nbytes(reply)
                token = req_id >> 32
                if token not in self._newest:
                    self._token_order.append(token)
                    while len(self._token_order) > self.token_capacity:
                        self._newest.pop(self._token_order.pop(0),
                                         None)
                self._newest[token] = req_id
                # evict FIFO past the entry/byte bound, but never a
                # client's newest entry — that one may be mid-retry
                scanned = 0
                while scanned < len(self._order) and \
                        (len(self._order) > self.capacity
                         or self._bytes > self.max_bytes):
                    old = self._order.pop(0)
                    if self._newest.get(old >> 32) == old:
                        self._order.append(old)  # protected; keep
                        scanned += 1
                        continue
                    gone = self._done.pop(old, None)
                    if gone is not None:
                        self._bytes -= _reply_nbytes(gone)
            self._cond.notify_all()

    def abort(self, req_id: int):
        with self._cond:
            self._inflight.discard(req_id)
            self._cond.notify_all()

    # -- snapshot support ----------------------------------------------
    def export(self) -> tuple[np.ndarray, list[bytes]]:
        """(ids, encoded replies) in retention order: a PS snapshot
        stores them beside the tables, in the same bytes as the JAX
        package's, so either package's shard restores the other's."""
        with self._cond:
            ids = np.array(self._order, np.uint64)
            blobs = [encode_body(self._done[i]) for i in self._order]
        return ids, blobs

    def import_(self, ids: np.ndarray, blobs: list[bytes]):
        with self._cond:
            self._done.clear()
            self._order = []
            self._bytes = 0
            self._newest = {}
            self._token_order = []
            for i, blob in zip(ids.tolist(), blobs):
                reply = decode_body(blob)
                self._done[int(i)] = reply
                self._order.append(int(i))
                self._bytes += _reply_nbytes(reply)
                if (int(i) >> 32) not in self._newest:
                    self._token_order.append(int(i) >> 32)
                self._newest[int(i) >> 32] = int(i)
            self._cond.notify_all()


class RpcServerState:
    """Per-server transport state shared by all connection handlers,
    with the parameter server's persistence and replication hooks."""

    def __init__(self, read_ops=frozenset(), secret: str | None = None,
                 dedup_capacity: int = 65536, after_commit=None,
                 commit_scope=None, after_retry=None,
                 expose_req_id: bool = False, before_reply=None):
        self.read_ops = frozenset(read_ops)
        # inject the wire request id into the skeleton as "_req_id"
        # before dispatch: the serving frontend keys a seedless sampled
        # request by it, so a retry replays the same tokens
        self.expose_req_id = bool(expose_req_id)
        self.secret = secret if secret is not None \
            else os.environ.get("PADDLE_PS_SECRET")
        self.dedup = DedupCache(dedup_capacity)
        # called with the op name when a MUTATING request is answered
        # from the dedup cache (client retry): the original dispatch may
        # have died between commit and its after_commit side effect, so
        # this is the hook's chance to finish pending persistence. It
        # must be idempotent and must NOT count a new mutation.
        self.after_retry = after_retry
        # called with the op name after a mutating op was dispatched and
        # its dedup entry recorded, BEFORE the reply is sent — the
        # snapshot hook runs here so a post-snapshot crash still yields
        # exactly-once on retry
        self.after_commit = after_commit
        # optional op -> lock/context-manager hook: when set, dispatch
        # + dedup.commit + after_commit run inside it, so a concurrent
        # snapshot export can never observe an applied mutation whose
        # dedup id is missing (or vice versa). Only ops whose dispatch
        # cannot block should return a scope — a barrier op waiting on
        # straggler trainers inside a shared lock would stall the shard
        self.commit_scope = commit_scope
        # optional (op, req, req_id, reply) hook called INSIDE the
        # commit scope right after dedup.commit — the WAL tier journals
        # the mutation (touched rows + request id) here, so a record is
        # on disk before the reply leaves and replay order matches
        # apply order
        self.journal = None
        # optional (op, req_id) hook called for mutating ops after
        # after_commit but BEFORE the reply frame is enqueued, OUTSIDE
        # the commit scope (it may block without serializing other
        # pushes) — the PS HA semi-sync ack gate waits here until K
        # standbys hold the journaled record (or degrades to async)
        self.before_reply = before_reply


# read ops a connection runs beside its workers when every worker is held
_READ_SPARE = 4


class _ServerConn:
    """One accepted connection's mux state: a writer thread serializes
    outgoing frames (replies and stream pushes from many concurrent
    handlers interleave on the wire), a bounded per-connection executor
    runs the handlers, and a cancel event per in-flight id lets
    F_CANCEL (or connection death) stop a dispatch generator."""

    def __init__(self, sock: socket.socket, dispatch,
                 state: RpcServerState):
        self.sock = sock
        self.dispatch = dispatch
        self.state = state
        self.dead = False
        self.max_workers = max(1, int(_env_float(
            "PADDLE_TPU_RPC_SERVER_INFLIGHT", 32)))
        self._sendq: queue.Queue = queue.Queue(maxsize=256)
        self._clock = threading.Lock()
        self._cancels: dict[int, threading.Event] = {}
        self._sem = threading.BoundedSemaphore(self.max_workers)
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_workers,
            thread_name_prefix="rpc-srv")
        # read ops (a health ping) that find every worker held by a long
        # call (a streamed generate) run on a thread of their own, up to
        # _READ_SPARE at once: behind the workers they would wait for a
        # stream to end, and a prober reads a busy peer as a dead one
        self._read_sem = threading.BoundedSemaphore(_READ_SPARE)
        self._writer_thread = threading.Thread(
            target=self._writer, daemon=True, name="rpc-srv-w")
        self._writer_thread.start()

    # -- outgoing -------------------------------------------------------
    def enqueue(self, obj, req_id: int, flags: int = 0):
        frame = _build_frame(obj, req_id, flags)
        while True:
            if self.dead:
                raise ConnectionError("connection writer is down")
            try:
                self._sendq.put((frame, req_id), timeout=1.0)
                return
            except queue.Full:
                continue

    def _requeue(self, frame: bytes, req_id: int):
        if not self.dead:
            with contextlib.suppress(queue.Full):
                self._sendq.put((frame, req_id), timeout=1.0)

    def _writer(self):
        while True:
            item = self._sendq.get()
            if item is None:
                return
            frame, rid = item
            try:
                _send_mux(self.sock, frame, "server", rid,
                          self._requeue)
            except Exception:
                self._fatal()
                return

    # -- incoming -------------------------------------------------------
    def run(self):
        hdr = bytearray(HEADER_SIZE)
        try:
            while True:
                try:
                    req, rid, flags, _n = _read_frame_mux(
                        self.sock, _BUFFER_POOL, hdr)
                except _FrameError as fe:
                    # corrupt body on an intact frame: answer THAT id
                    # with a retryable wire error; every other call on
                    # this socket is untouched
                    _MUX_FRAME_ERRORS.labels(side="server").inc()
                    if not fe.flags & F_CANCEL:
                        self.enqueue(
                            {"error": f"WireError: {fe}",
                             "kind": "wire"}, fe.req_id, F_ERROR)
                    continue
                if flags & F_CANCEL:
                    with self._clock:
                        ev = self._cancels.get(rid)
                    if ev is not None:
                        ev.set()
                    continue
                # re-read the injector each request: a chaos drill that
                # (re)arms the knobs mid-run must hit connections that
                # were already open (the writer reads it per frame too)
                inj = injector()
                armed = inj.count_request() if inj.active else False
                if inj.active:
                    inj.maybe_kill("recv", armed)
                cancel_ev = threading.Event()
                with self._clock:
                    self._cancels[rid] = cancel_ev
                op = req.get("op") if isinstance(req, dict) else None
                if not self._sem.acquire(blocking=False):
                    if op in self.state.read_ops \
                            and self._read_sem.acquire(blocking=False):
                        threading.Thread(
                            target=self._handle, daemon=True,
                            name="rpc-srv-read",
                            args=(req, rid, cancel_ev, armed,
                                  self._read_sem)).start()
                        continue
                    self._sem.acquire()
                try:
                    self._pool.submit(self._handle, req, rid,
                                      cancel_ev, armed)
                except BaseException:
                    self._sem.release()
                    raise
        except (PSAuthError, WireError, ConnectionError, OSError):
            pass
        finally:
            self._shutdown()

    # -- handler --------------------------------------------------------
    def _drain(self, gen, req_id: int, cancel_ev: threading.Event):
        """Send every yielded object as an F_STREAM frame; the return
        value is the final reply. F_CANCEL (or connection death)
        surfaces between frames as _Cancelled — gen.close() raises
        GeneratorExit at the dispatch generator's yield point so it can
        cancel whatever produced the stream."""
        try:
            while True:
                try:
                    item = next(gen)
                except StopIteration as stop:
                    return stop.value if stop.value is not None else {}
                if cancel_ev.is_set():
                    raise _Cancelled()
                self.enqueue(item, req_id, F_STREAM)
        finally:
            gen.close()

    def _handle(self, req, req_id: int, cancel_ev: threading.Event,
                armed: bool, slot=None):
        """One request, on a worker (`slot` None: it holds a _sem slot)
        or on a read op's own thread (`slot` the _read_sem it holds)."""
        state = self.state
        try:
            op = req.get("op") if isinstance(req, dict) else None
            # wire-carried trace id (TRACE_KEY in the skeleton):
            # stripped before dispatch, re-rooted as this side's span
            # context so handler-side spans join the caller's trace
            wire_tid = req.pop(TRACE_KEY, None) \
                if isinstance(req, dict) else None
            if state.expose_req_id and isinstance(req, dict):
                req["_req_id"] = req_id
            _SERVER_REQS.labels(op=op or "?").inc()
            _flight.record("rpc", "server_request",
                           trace_id=wire_tid, op=op or "?",
                           req_id=req_id)
            inj = injector()
            mutating = op not in state.read_ops
            if mutating and req_id:
                cached = state.dedup.begin(req_id)
                if cached is not _FRESH:
                    _SERVER_DEDUP_HITS.labels(op=op or "?").inc()
                    if state.after_retry is not None:
                        state.after_retry(op)
                    if inj.active:
                        inj.maybe_kill("reply", armed)
                    self.enqueue(cached, req_id)
                    return
            err = None
            scope = state.commit_scope(op) \
                if state.commit_scope is not None else None
            with scope if scope is not None else _NULL_SCOPE:
                try:
                    with _tracing.span(f"rpc.server.{op or 'raw'}",
                                       trace_id=wire_tid,
                                       op=op or "?"):
                        rep = self.dispatch(req)
                        if isinstance(rep, types.GeneratorType):
                            rep = self._drain(rep, req_id, cancel_ev)
                except _Cancelled:
                    # the client abandoned this id: no reply to send,
                    # nothing to memoise — the op did not complete
                    if mutating and req_id:
                        state.dedup.abort(req_id)
                    return
                except Exception as e:
                    # application/dispatch failure (including barrier
                    # timeouts): report as an error frame instead of
                    # silently killing the connection
                    if mutating and req_id:
                        state.dedup.abort(req_id)
                    err = {"error": f"{type(e).__name__}: {e}",
                           "kind": "app"}
                else:
                    if mutating and req_id:
                        state.dedup.commit(req_id, rep)
                        if state.journal is not None:
                            # WAL write-ahead: rows + request id land
                            # on disk inside the commit scope, so a
                            # crash-restore replays this mutation AND
                            # dedups its retry (exactly-once survives)
                            state.journal(op, req, req_id, rep)
            if err is not None:
                _SERVER_ERRORS.labels(op=op or "?").inc()
                _flight.record("rpc", "server_error",
                               trace_id=wire_tid, op=op or "?",
                               error=err.get("error"))
                self.enqueue(err, req_id, F_ERROR)
                return
            if mutating and state.after_commit is not None:
                # outside the commit scope (a snapshot's disk write
                # must not stall other pushes on the commit lock) but
                # before the reply: a crash in here still resolves to
                # exactly-once — the mutation IS committed, so the
                # client's retry lands on the dedup cache. Failures
                # (e.g. snapshot disk error) propagate and end the
                # connection for the same reason.
                state.after_commit(op)
            if mutating and req_id and state.before_reply is not None:
                state.before_reply(op, req_id)
            if inj.active:
                inj.maybe_kill("reply", armed)
            self.enqueue(rep, req_id)
        except Exception:
            # writer down / encode failure: the connection is beyond
            # per-request recovery
            self._fatal()
        finally:
            with self._clock:
                self._cancels.pop(req_id, None)
            (self._sem if slot is None else slot).release()

    # -- teardown -------------------------------------------------------
    def _fatal(self):
        self.dead = True
        # _hard_close: run() is blocked in recv on this socket — a bare
        # close would strand it (and the client) until their timeouts
        _hard_close(self.sock)

    def _shutdown(self):
        self.dead = True
        with self._clock:
            cancels = list(self._cancels.values())
        for ev in cancels:
            # connection death cancels every in-flight stream: their
            # next frame can never be delivered
            ev.set()
        self._sendq.put(None)
        self._pool.shutdown(wait=False)
        _hard_close(self.sock)


def serve_connection(sock: socket.socket, dispatch, state: RpcServerState):
    """One connection's multiplexed request loop. Requests are handled
    concurrently (bounded by PADDLE_TPU_RPC_SERVER_INFLIGHT; a read op
    that finds every worker busy runs beside them, _READ_SPARE at once)
    and their replies/stream frames interleave on the wire, each tagged
    with its request id. Application errors become error frames; body-local
    corruption poisons only its own request id; transport errors end
    the connection (the client's retry path owns recovery). A dispatch
    that returns a GENERATOR streams: yielded objects go out as
    F_STREAM frames, the generator's return value is the final
    (dedup-memoised) reply; an F_CANCEL from the client raises
    GeneratorExit into the generator."""
    try:
        # server-push streams (replication feeds, invalidations,
        # pub_watch) are one-directional: without NODELAY, Nagle holds
        # each small frame for the peer's delayed ACK (~40ms/record)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    try:
        server_handshake(sock, state.secret)
    except (PSAuthError, WireError, ConnectionError, OSError):
        _hard_close(sock)
        return
    _ServerConn(sock, dispatch, state).run()
