"""The port's multiplexed RPC wire (paddle_tpu_torch/distributed/fleet/
runtime/rpc.py) on the CPU, held to the JAX package's:

  * frames and bodies byte-equal to the reference's for the same
    objects, and each side decodes the other's (no pickle anywhere: a
    JSON skeleton and whitelisted ndarray segments);
  * the malformed bodies the reference refuses, refused alike;
  * the transport cases of tests/test_rpc_mux.py that need no PS tier
    (out-of-order replies, the legacy one-call channel, zero-copy pulls,
    buffer reuse, streams beside pings, stream cancel, exactly-once over
    a pinned id, frame-granular corrupt / delay / drop faults, the
    metric families);
  * a reference RpcClient against a port server and the reverse,
    including streams and the HMAC handshake.

The PS push-invalidation cases wait for ROADMAP item 16 (the PS tier),
the lock-order sanitizer run for item 19 (analysis/).
"""
import socketserver
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed.fleet.runtime import fault_injection as jfi
from paddle_tpu.distributed.fleet.runtime import rpc as jrpc
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.distributed.fleet.runtime import rpc

MODS = {"port": rpc, "jax": jrpc}


@pytest.fixture(autouse=True)
def _clean_injector():
    for m in (fi, jfi):
        m.reset_injector(m.FaultInjector())
    yield
    for m in (fi, jfi):
        m.reset_injector(m.FaultInjector())


def _mval(metric, **labels) -> float:
    """Sum a metric family's series matching a label subset."""
    names = metric.labelnames
    total = 0.0
    for vals, child in metric._series():
        kv = dict(zip(names, vals))
        if all(kv.get(k) == v for k, v in labels.items()):
            total += child.value
    return total


# ---------------------------------------------------------------------------
# the codec: byte-equal to the reference
# ---------------------------------------------------------------------------

OBJECTS = {
    "none": None,
    "str": "pong",
    "nested": {"op": "generate", "max_new_tokens": 7, "deadline": None,
               "tenant": "web", "flags": [True, False, 1.5, "x"]},
    "prompt": {"op": "generate",
               "prompt": np.array([3, 1, 4, 1, 5, 9], np.int32)},
    "arrays": {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
               "b": [np.zeros((0, 2), np.int64), np.array(7, np.uint8)],
               "c": np.array([True, False])},
    "every_dtype": [np.arange(3).astype(d) for d in (
        "float32", "float64", "float16", "int64", "int32", "int16",
        "int8", "uint64", "uint32", "uint16", "uint8", "bool")],
    "numpy_scalars": {"i": np.int64(5), "f": np.float32(0.25),
                      "t": (1, 2, (3,))},
    "strided": {"x": np.arange(24, dtype=np.float64).reshape(4, 6)[:, ::2]},
    "unicode": {"msg": "naïve — ✓", "k": {"nested": {"deep": [1, [2]]}}},
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_encode_body_is_byte_equal(name):
    obj = OBJECTS[name]
    assert rpc.encode_body(obj) == jrpc.encode_body(obj)


@pytest.mark.parametrize("req_id,flags", [
    (0, 0), (1, 0), ((0xDEADBEEF << 32) | 42, 0), (7, rpc.F_STREAM),
    (9, rpc.F_CANCEL), (11, rpc.F_ERROR), (0, rpc.F_HANDSHAKE)])
def test_frames_are_byte_equal(req_id, flags):
    for obj in (OBJECTS["prompt"], OBJECTS["arrays"], {"error": "x"}):
        a = rpc._build_frame(obj, req_id, flags)
        assert a == jrpc._build_frame(obj, req_id, flags)
        assert len(a) == rpc.HEADER_SIZE + len(rpc.encode_body(obj))
    assert (rpc.PROTOCOL_VERSION, rpc._MAGIC, rpc.HEADER_SIZE) == \
        (jrpc.PROTOCOL_VERSION, jrpc._MAGIC, jrpc.HEADER_SIZE)
    assert (rpc.F_ERROR, rpc.F_HANDSHAKE, rpc.F_STREAM, rpc.F_CANCEL) \
        == (jrpc.F_ERROR, jrpc.F_HANDSHAKE, jrpc.F_STREAM, jrpc.F_CANCEL)


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_each_side_decodes_the_others_body(name):
    obj = OBJECTS[name]
    for enc, dec in ((jrpc, rpc), (rpc, jrpc)):
        _same(dec.decode_body(enc.encode_body(obj)),
              jrpc.decode_body(jrpc.encode_body(obj)))


def _skel(s: bytes) -> bytes:
    import struct
    return struct.pack("<I", len(s)) + s


MALFORMED = {
    "short": b"\x01\x00",
    "skeleton_past_body": b"\xff\x00\x00\x00{}",
    "bad_json": _skel(b"{not json"),
    "dangling_ref": _skel(b'{"__nd__": 0}'),
    "bad_dtype_code": _skel(b"null") + bytes([99, 0]),
    "truncated_dims": _skel(b"null") + bytes([0, 2]) + b"\x01\x00",
    "negative_dim": _skel(b"null") + bytes([0, 1])
    + (-1).to_bytes(8, "little", signed=True),
    "data_past_body": _skel(b"null") + bytes([0, 1])
    + (1 << 40).to_bytes(8, "little"),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_bodies_are_refused_alike(name):
    body = MALFORMED[name]
    msgs = []
    for mod in (rpc, jrpc):
        with pytest.raises(mod.WireError) as ei:
            mod.decode_body(body)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_unsafe_dtypes_never_reach_the_wire():
    for mod in (rpc, jrpc):
        with pytest.raises(TypeError, match="not wire-safe"):
            mod.encode_body({"x": np.array([object()])})
        with pytest.raises(TypeError, match="not wire-safe"):
            mod.encode_body(np.zeros(2, np.complex64))
    assert [str(d) for d in rpc._DTYPES] == [str(d) for d in jrpc._DTYPES]


@pytest.mark.parametrize("capacity", [2, 4, 64])
def test_dedup_cache_keeps_and_evicts_like_the_reference(capacity):
    """The same commits from three clients through both packages'
    DedupCache keep the same ids, in the same order, and replay the same
    replies: FIFO eviction past the bound, never a client's newest."""
    caches = {}
    for mod in (rpc, jrpc):
        c = mod.DedupCache(capacity=capacity)
        for i in range(12):
            rid = ((i % 3 + 1) << 32) | i
            assert c.begin(rid) is mod._FRESH
            c.commit(rid, {"n": i, "rows": np.full((2, 2), i, np.int32)})
        c.abort((9 << 32) | 1)                  # never begun: a no-op
        caches[mod] = c
    p, j = caches[rpc], caches[jrpc]
    assert p._order == j._order and p._bytes == j._bytes
    assert len(p._order) >= min(capacity, 12)
    for rid in p._order:
        _same(p.begin(rid), j.begin(rid))
    newest = {((k + 1) << 32) | max(i for i in range(12) if i % 3 == k)
              for k in range(3)}
    assert newest <= set(p._order)


def test_buffer_pool_size_classes_and_reuse():
    pool = rpc.BufferPool(max_bytes=1 << 20)
    b = pool.acquire(5000)
    assert len(b) == 8192
    pool.release(b)
    assert pool.acquire(4097) is b and pool.stats()["hits"] == 1
    assert len(pool.acquire(1)) == 4096


# ---------------------------------------------------------------------------
# stub dispatch servers over either package's serve_connection
# ---------------------------------------------------------------------------

class _StubServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, mod=rpc, secret=None):
        self.applied: list = []
        self._apply_lock = threading.Lock()
        state = mod.RpcServerState(
            read_ops=frozenset({"ping", "slow", "pull", "gen", "echo"}),
            secret=secret)
        outer = self

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                mod.serve_connection(self.request, outer._dispatch, state)

        super().__init__(("127.0.0.1", 0), H)
        self.endpoint = f"127.0.0.1:{self.server_address[1]}"
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _dispatch(self, req):
        op = req["op"]
        if op == "ping":
            return "pong"
        if op == "echo":
            return {k: v for k, v in req.items() if k != "op"}
        if op == "slow":
            time.sleep(float(req.get("s", 0.3)))
            return {"ok": True}
        if op == "pull":
            n, d = int(req["n"]), int(req["d"])
            return {"rows": np.arange(n * d, dtype=np.float32)
                    .reshape(n, d)}
        if op == "gen":
            def g():
                for i in range(int(req["n"])):
                    time.sleep(float(req.get("gap", 0.05)))
                    yield {"i": i}
                return {"done": True}
            return g()
        if op == "apply":
            with self._apply_lock:
                self.applied.append(req["x"])
                return {"n": len(self.applied)}
        if op == "boom":
            raise KeyError("no such thing")
        raise ValueError(f"unknown op {op!r}")

    def stop(self):
        self.shutdown()
        self.server_close()
        self._thread.join(timeout=10)


@pytest.fixture()
def stub():
    srv = _StubServer()
    yield srv
    srv.stop()


# ---------------------------------------------------------------------------
# multiplexing semantics (the reference's transport cases)
# ---------------------------------------------------------------------------

def test_out_of_order_reply_overtakes_slow_call(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        ooo0 = _mval(rpc._MUX_OUT_OF_ORDER)
        slow_done = []
        th = threading.Thread(target=lambda: slow_done.append(
            cli.call({"op": "slow", "s": 0.5}, timeout=5)))
        th.start()
        time.sleep(0.1)
        t0 = time.monotonic()
        assert cli.call({"op": "ping"}, timeout=5) == "pong"
        ping_t = time.monotonic() - t0
        th.join(timeout=10)
        assert slow_done and slow_done[0] == {"ok": True}
        assert ping_t < 0.3, f"ping serialized ({ping_t:.3f}s)"
        assert _mval(rpc._MUX_OUT_OF_ORDER) > ooo0
    finally:
        cli.close()


def test_legacy_mode_serializes_one_call_per_channel(stub):
    cli = rpc.RpcClient(stub.endpoint, mux=False, pool_size=1)
    try:
        th = threading.Thread(
            target=lambda: cli.call({"op": "slow", "s": 0.4}, timeout=5))
        th.start()
        time.sleep(0.1)
        t0 = time.monotonic()
        assert cli.call({"op": "ping"}, timeout=5) == "pong"
        ping_t = time.monotonic() - t0
        th.join(timeout=10)
        assert ping_t > 0.2, f"legacy mode did not serialize ({ping_t:.3f}s)"
    finally:
        cli.close()


def test_zero_copy_pull_skips_body_assembly_copy(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        n, d = 512, 64
        c0 = _mval(rpc._MUX_BYTES_COPIED, path="mux")
        rows = cli.call({"op": "pull", "n": n, "d": d}, timeout=10)["rows"]
        assert rows.shape == (n, d) and float(rows[3, 5]) == 3 * d + 5
        copied = _mval(rpc._MUX_BYTES_COPIED, path="mux") - c0
        assert copied < n * d * 4 / 10, f"pull copied {copied}B"
    finally:
        cli.close()


def test_buffer_pool_reclaims_after_views_die(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        for _ in range(8):
            rep = cli.call({"op": "pull", "n": 256, "d": 16}, timeout=10)
            assert rep["rows"].shape == (256, 16)
            del rep
        st = rpc._BUFFER_POOL.stats()
        assert st["hits"] >= 1, f"no buffer reuse: {st}"
    finally:
        cli.close()


def test_stream_and_pings_interleave_on_one_channel(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        results = []

        def consume():
            toks = []
            for f in cli.call_stream({"op": "gen", "n": 8, "gap": 0.08},
                                     timeout=10, stream_timeout=10):
                toks.append(f["i"])
            results.append(toks)

        threads = [threading.Thread(target=consume) for _ in range(3)]
        for th in threads:
            th.start()
        time.sleep(0.1)
        lats = []
        for _ in range(10):
            t0 = time.monotonic()
            assert cli.call({"op": "ping"}, timeout=5) == "pong"
            lats.append(time.monotonic() - t0)
        for th in threads:
            th.join(timeout=30)
        assert results == [list(range(8))] * 3
        assert max(lats) < 0.25, f"ping behind streams ({max(lats):.3f}s)"
    finally:
        cli.close()


def test_abandoned_stream_cancels_and_channel_survives(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        gen = cli.call_stream({"op": "gen", "n": 50, "gap": 0.05},
                              timeout=10, stream_timeout=10)
        assert next(gen)["i"] == 0
        gen.close()
        for _ in range(3):
            assert cli.call({"op": "ping"}, timeout=5) == "pong"
        assert cli.stats.as_dict()["reconnects"] == 0
    finally:
        cli.close()


def test_exactly_once_with_pinned_req_id_over_mux(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        rid = (0x5EED << 32) | 7
        r1 = cli.call({"op": "apply", "x": 1}, req_id=rid, timeout=5)
        r2 = cli.call({"op": "apply", "x": 1}, req_id=rid, timeout=5)
        assert r1 == r2 == {"n": 1}
        assert stub.applied == [1]
    finally:
        cli.close()


def test_remote_error_is_not_retried(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        with pytest.raises(rpc.PSRemoteError, match="KeyError"):
            cli.call({"op": "boom"}, timeout=5)
        snap = cli.stats.as_dict()
        assert snap["remote_errors"] == 1 and snap["retries"] == 0
    finally:
        cli.close()


def test_corrupt_one_frame_fails_only_its_call(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        rid = (0xF00D << 32) | 42
        fi.injector().set_frame_fault("corrupt", req=str(rid),
                                      side="client")
        slow_done = []
        th = threading.Thread(target=lambda: slow_done.append(
            cli.call({"op": "slow", "s": 0.4}, timeout=10)))
        th.start()
        time.sleep(0.05)
        assert cli.call({"op": "ping"}, req_id=rid, timeout=10) == "pong"
        th.join(timeout=15)
        assert slow_done == [{"ok": True}]
        snap = cli.stats.as_dict()
        assert snap["corrupt_frames"] >= 1 and snap["retries"] >= 1
        assert snap["reconnects"] == 0
        assert fi.injector().counters["frame_faults"] == 1
    finally:
        cli.close()


def test_delay_one_frame_lets_later_frames_overtake(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        rid = (0xCAFE << 32) | 9
        fi.injector().set_frame_fault("delay", req=str(rid), delay=0.4,
                                      side="client")
        delayed_done = []
        th = threading.Thread(target=lambda: delayed_done.append(
            cli.call({"op": "ping"}, req_id=rid, timeout=10)))
        th.start()
        time.sleep(0.05)
        t0 = time.monotonic()
        assert cli.call({"op": "ping"}, timeout=10) == "pong"
        overtake_t = time.monotonic() - t0
        th.join(timeout=10)
        assert delayed_done == ["pong"]
        assert overtake_t < 0.3, f"queued behind the delay ({overtake_t:.3f}s)"
    finally:
        cli.close()


def test_drop_one_frame_retries_and_succeeds(stub):
    cli = rpc.RpcClient(stub.endpoint, pool_size=1, timeout=0.5,
                        deadline=10.0)
    try:
        fi.injector().set_frame_fault("drop", side="client")
        assert cli.call({"op": "ping"}) == "pong"
        assert cli.stats.as_dict()["retries"] >= 1
        assert fi.injector().counters["frame_faults"] == 1
    finally:
        cli.close()


def test_deadline_exhausted_raises_deadline_error():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                                 # nothing listens there
    cli = rpc.RpcClient(f"127.0.0.1:{port}", timeout=0.2, deadline=0.6,
                        backoff=0.01)
    try:
        with pytest.raises(rpc.PSDeadlineError, match="failed after"):
            cli.call({"op": "ping"})
        assert cli.stats.as_dict()["deadline_exceeded"] == 1
    finally:
        cli.close()


def test_mux_metric_families_registered(stub):
    from paddle_tpu_torch.observability import registry as _obs
    cli = rpc.RpcClient(stub.endpoint, pool_size=1)
    try:
        cli.call({"op": "ping"}, timeout=5)
    finally:
        cli.close()
    text = _obs.prometheus_text()
    for name in ("paddle_tpu_rpc_mux_inflight",
                 "paddle_tpu_rpc_mux_channels",
                 "paddle_tpu_rpc_mux_bytes_copied_total",
                 "paddle_tpu_rpc_mux_out_of_order_total",
                 "paddle_tpu_rpc_client_latency_seconds",
                 "paddle_tpu_rpc_server_requests_total"):
        assert name in text, f"{name} missing from exposition"


# ---------------------------------------------------------------------------
# across packages: either client against either server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client,server", [("jax", "port"),
                                           ("port", "jax")])
def test_clients_and_servers_interoperate(client, server):
    srv = _StubServer(MODS[server])
    cli = MODS[client].RpcClient(srv.endpoint, pool_size=2)
    try:
        assert cli.call({"op": "ping"}, timeout=5) == "pong"
        arrays = OBJECTS["arrays"]
        _same(cli.call({"op": "echo", **arrays}, timeout=5), arrays)
        rows = cli.call({"op": "pull", "n": 64, "d": 8}, timeout=5)["rows"]
        np.testing.assert_array_equal(
            rows, np.arange(512, dtype=np.float32).reshape(64, 8))
        got = []
        final = cli.call({"op": "gen", "n": 5, "gap": 0.01}, timeout=5,
                         on_stream=lambda f: got.append(f["i"]))
        assert got == list(range(5)) and final == {"done": True}
        rid = (0xABCD << 32) | 3
        assert cli.call({"op": "apply", "x": 9}, req_id=rid) == {"n": 1}
        assert cli.call({"op": "apply", "x": 9}, req_id=rid) == {"n": 1}
        assert srv.applied == [9]
        with pytest.raises(MODS[client].PSRemoteError, match="unknown op"):
            cli.call({"op": "nope"}, timeout=5)
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("client,server", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port", "port")])
def test_hmac_handshake_across_packages(client, server):
    srv = _StubServer(MODS[server], secret="s3cret")
    try:
        good = MODS[client].RpcClient(srv.endpoint, secret="s3cret")
        try:
            assert good.call({"op": "ping"}, timeout=5) == "pong"
        finally:
            good.close()
        bad = MODS[client].RpcClient(srv.endpoint, secret="wrong",
                                     deadline=5.0)
        try:
            with pytest.raises(MODS[client].PSAuthError):
                bad.call({"op": "ping"}, timeout=5)
        finally:
            bad.close()
        none = MODS[client].RpcClient(srv.endpoint, secret=None,
                                      deadline=5.0)
        none.secret = None                    # ignore PADDLE_PS_SECRET
        try:
            with pytest.raises(MODS[client].PSAuthError,
                               match="PADDLE_PS_SECRET"):
                none.call({"op": "ping"}, timeout=5)
        finally:
            none.close()
    finally:
        srv.stop()
