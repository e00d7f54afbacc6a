"""Zero-downtime weight swaps on the port's serving engine, on the CPU:
the engine-side cases of tests/test_online_swap.py (stats / ping /
adopt_version carry model_version, adopt_version needs a configured
publish root, the file-poll subscriber swaps and memoizes a bad
version), a swap under LoadGenerator load on one ServingServer with the
subscriber watching the registry over the wire (every request done, a
streamed generate contiguous across the flip, post-swap tokens those of
a fresh engine on the published version), a PS shard serving the pub_*
verbs to a subscriber, and the launcher's --publish_dir reaching the
server.* and replica.* children only; the router's staggered rollout
over two in-process replicas with its automatic rollback of the fleet
and the registry, and publish_watch rolling a publication out with no
operator verb.

Tiny GPT (hidden 128, 2 layers, vocab 512, initializer range 0.5); token
comparisons are exact (one package). Every wait has its own timeout.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.distributed.fleet.runtime.parameter_server_runtime \
    import PSClient, PSServer
from paddle_tpu_torch.distributed.fleet.runtime.rpc import (PSRemoteError,
                                                   RpcClient)
from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
from paddle_tpu_torch.publish import (Publisher, RegistryServer,
                                      VersionRegistry, VersionSubscriber)
from paddle_tpu_torch.serving import (Engine, GPTDecodeModel,
                                      InProcessReplica, LoadGenerator,
                                      Router, ServingClient, ServingServer,
                                      TrafficConfig, slo_report)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(vocab_size=512, hidden_size=128, num_heads=2, num_layers=2,
            max_position_embeddings=128, initializer_range=0.5)
ENGINE_KW = dict(num_slots=4, num_pages=64, page_size=4, max_seq_len=64)


def _model(seed: int) -> GPTDecodeModel:
    cfg = GPTConfig(**SIZE)
    return GPTDecodeModel(cfg, params=init_gpt_params(cfg, seed=seed),
                          device="cpu")


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("swap") / "gpt")
    _model(0).save_checkpoint(root)
    return root


def _engine(ckpt_root) -> Engine:
    return Engine.from_checkpoint(ckpt_root, device="cpu", **ENGINE_KW)


def _wait_for(pred, timeout=30.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def _publish_seed(pub_root: str, seed: int, step: int) -> dict:
    """Publish a fresh model's weights as one servable version."""
    return Publisher(pub_root).publish_model(_model(seed), step=step)


def _expected_after_swap(ckpt_root, pub_root, version, prompt, mnt):
    """Reference output: a FRESH engine warm-started onto the
    published version — what every post-swap engine must emit."""
    eng = _engine(ckpt_root)
    with eng:
        eng.warm_start(pub_root, step=version, version=version)
        return eng.generate(prompt, mnt, timeout=60).tolist()


# ---------------------------------------------------------------------------
# version identity on the wire
# ---------------------------------------------------------------------------

def test_stats_ping_and_adopt_version_carry_model_version(ckpt_root,
                                                          tmp_path):
    pub = str(tmp_path / "pub")
    rec = _publish_seed(pub, seed=1, step=50)
    assert rec["version"] == 1
    eng = _engine(ckpt_root)
    assert eng.stats()["model_version"] == 0
    with eng, ServingServer(eng, "127.0.0.1:0",
                            publish_root=pub) as srv:
        cli = ServingClient(srv.endpoint)
        try:
            assert cli.ping_info()["model_version"] == 0
            rep = cli.adopt_version(1)
            assert rep == {"adopted": 1, "model_version": 1}
            assert cli.ping_info()["model_version"] == 1
            assert eng.stats()["model_version"] == 1
            # serving the adopted weights, not just stamping them
            assert eng.generate([1, 2, 3], 8, timeout=60).tolist() \
                == _expected_after_swap(ckpt_root, pub, 1, [1, 2, 3], 8)
        finally:
            cli.close()


def test_adopt_version_requires_configured_root(ckpt_root, monkeypatch):
    """Restore paths are server configuration, never wire-chosen —
    with no publish root the verb is refused."""
    monkeypatch.delenv("PADDLE_TPU_PUBLISH_DIR", raising=False)
    eng = _engine(ckpt_root)
    with eng, ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            with pytest.raises(PSRemoteError, match="publish_root"):
                cli.adopt_version(1)
        finally:
            cli.close()


# ---------------------------------------------------------------------------
# subscriber hot swap (single engine, file-poll transport)
# ---------------------------------------------------------------------------

def test_subscriber_file_poll_swaps_and_skips_bad_versions(ckpt_root,
                                                           tmp_path):
    pub = str(tmp_path / "pub")
    eng = _engine(ckpt_root)
    sub = VersionSubscriber(pub, engine=eng, poll=0.05)
    with eng:
        sub.start()
        try:
            _publish_seed(pub, seed=1, step=10)
            assert _wait_for(lambda: sub.current_version == 1)
            assert eng.stats()["model_version"] == 1
            # a torn/bogus publication fails its swap ONCE, memoized
            Publisher(pub).publish_arrays({"junk": np.zeros(4)}, step=11,
                                          kind="gpt-decode")
            assert _wait_for(lambda: 2 in sub.failed_versions)
            assert sub.current_version == 1   # still on good weights
            # the next good version (the recovery path) adopts normally
            _publish_seed(pub, seed=2, step=12)
            assert _wait_for(lambda: sub.current_version == 3)
            assert eng.generate([4, 5], 6, timeout=60).tolist() \
                == _expected_after_swap(ckpt_root, pub, 3, [4, 5], 6)
        finally:
            sub.stop()


# ---------------------------------------------------------------------------
# staggered fleet rollout through the router
# ---------------------------------------------------------------------------

def _fleet(ckpt_root, pub_root, n=2, **router_kw):
    reps = []
    for i in range(n):
        r = InProcessReplica(ckpt_root, name=f"rep{i}",
                             engine_kw=dict(ENGINE_KW, device="cpu"),
                             publish_root=pub_root)
        r.start()
        reps.append(r)
    # the post-swap probe shares ping_timeout with the health loop: a
    # loaded host's ping past it would read as a failed swap and roll
    # the fleet back, so it is generous here
    kw = dict(ping_interval=0.1, ping_timeout=10.0, suspect_after=1,
              dead_after=2, token_stall=5.0, respawn_cooldown=0.2,
              publish_root=pub_root)
    kw.update(router_kw)
    router = Router("127.0.0.1:0", replicas=[r.spec() for r in reps],
                    **kw)
    return router, reps


def test_rollout_staggers_fleet_and_bad_version_rolls_back(ckpt_root,
                                                           tmp_path):
    pub = str(tmp_path / "pub")
    router, reps = _fleet(ckpt_root, pub)
    try:
        with router:
            _publish_seed(pub, seed=1, step=100)
            # the rollout driven over the router's own wire
            rc = RpcClient(router.endpoint)
            try:
                rep = rc.call({"op": "rollout"}, timeout=120,
                              deadline=120)
                assert rep["adopted"] == 1
                assert sorted(rep["replicas"]) == ["rep0", "rep1"]
                for r in reps:
                    assert r.engine.stats()["model_version"] == 1
                # pin the good version, then publish a junk one: the
                # rollout fails on the first replica, restores the
                # fleet and rewinds the registry pointer
                VersionRegistry(pub).pin(1)
                Publisher(pub).publish_arrays(
                    {"junk": np.zeros(3)}, step=110, kind="gpt-decode")
                rep2 = rc.call({"op": "rollout"}, timeout=120,
                               deadline=120)
                assert rep2["adopted"] is None
                assert rep2["version"] == 2
                assert rep2["failed_on"] == "rep0"
                assert rep2["rolled_back"] == 1   # the registry rewound
                assert VersionRegistry(pub).latest() == 1
                assert router.rollout_rollbacks == 1
                for r in reps:
                    assert r.engine.stats()["model_version"] == 1
                # and the fleet still serves, on the good weights
                cli = ServingClient(router.endpoint)
                try:
                    out = cli.generate([1, 2, 3], 8, timeout=60)
                    assert out["status"] == "done"
                    assert np.asarray(out["tokens"]).tolist() == \
                        _expected_after_swap(ckpt_root, pub, 1,
                                             [1, 2, 3], 8)
                finally:
                    cli.close()
            finally:
                rc.close()
    finally:
        for r in reps:
            r.stop()


def test_router_publish_watch_rolls_out_automatically(ckpt_root,
                                                      tmp_path):
    """publish_watch=True closes the loop with no operator verb: the
    publication itself triggers the staggered fleet rollout."""
    pub = str(tmp_path / "pub")
    router, reps = _fleet(ckpt_root, pub, publish_watch=True)
    try:
        with router:
            _publish_seed(pub, seed=1, step=100)
            # the rollout counts itself once its last post-swap probe
            # answered, a moment after the last engine flipped
            assert _wait_for(
                lambda: router.rollouts >= 1
                and all(r.engine.stats()["model_version"] == 1
                        for r in reps), timeout=120)
            assert router.rollout_rollbacks == 0
    finally:
        for r in reps:
            r.stop()


# ---------------------------------------------------------------------------
# swap under load, over the wire
# ---------------------------------------------------------------------------

def test_zero_downtime_swap_under_load(ckpt_root, tmp_path):
    """Open-loop traffic through one ServingServer while a version
    publishes and the subscriber (watching a RegistryServer over the
    wire) adopts it: no request rejected or failed, one streamed
    generate launched just before the flip keeps contiguous frames, and
    the engine then serves the new weights."""
    pub = str(tmp_path / "pub")
    eng = _engine(ckpt_root)
    flip = {}
    stream_frames, stream_rep = [], {}
    with RegistryServer(pub) as reg_srv, eng, \
            ServingServer(eng, "127.0.0.1:0", publish_root=pub) as srv:
        sub = VersionSubscriber(pub, engine=eng, endpoint=reg_srv.endpoint)
        sub.start()
        cli = ServingClient(srv.endpoint)
        try:
            gen = LoadGenerator(TrafficConfig(
                rate=6.0, duration=4.0, seed=11, vocab_size=512,
                prompt_lens={4: 2, 8: 1}, output_lens={2: 2, 4: 1},
                deadlines={0: 60.0, 1: 60.0, 2: 60.0}))

            def spanning_stream():
                c2 = ServingClient(srv.endpoint)
                try:
                    stream_rep.update(c2.generate(
                        [9, 8, 7], 24, timeout=90, stream=True,
                        on_token=lambda t, i:
                        stream_frames.append((i, list(t)))))
                finally:
                    c2.close()

            def mid_run_publish():
                time.sleep(1.5)
                th = threading.Thread(target=spanning_stream)
                th.start()
                time.sleep(0.2)
                flip["t"] = time.monotonic()
                _publish_seed(pub, seed=1, step=200)
                flip["adopted"] = _wait_for(
                    lambda: sub.current_version == 1, timeout=60)
                th.join(90)

            pub_thread = threading.Thread(target=mid_run_publish)
            pub_thread.start()
            res = gen.run_client(cli, timeout=60)
            pub_thread.join(120)
            assert not pub_thread.is_alive()
            assert res.wait(120)
        finally:
            cli.close()
            sub.stop()
    assert flip["adopted"] and eng.stats()["model_version"] == 1
    # no drops: every offered request was admitted and ran to the end
    assert res.rejected == []
    statuses = [h.status for _a, h in res.handles]
    assert statuses and all(s == "done" for s in statuses), statuses
    # streamed tokens stayed contiguous across the swap
    assert stream_rep["status"] == "done"
    streamed = []
    for idx, toks in stream_frames:
        assert idx == len(streamed)       # no gap, no dup
        streamed.extend(int(t) for t in toks)
    assert streamed == np.asarray(stream_rep["tokens"]).tolist()
    assert len(streamed) == 24
    flip_rel = flip["t"] - res.started_at
    pre = slo_report(res, window=(0.0, flip_rel), gen="pre")
    post = slo_report(res, window=(flip_rel, float("inf")), gen="post")
    assert pre["offered"] > 0 and post["offered"] > 0
    # post-swap outputs are the new weights'
    with eng:
        got = eng.generate([1, 2, 3], 8, timeout=60).tolist()
    assert got == _expected_after_swap(ckpt_root, pub, 1, [1, 2, 3], 8)


# ---------------------------------------------------------------------------
# the PS shard serves the registry verbs to a subscriber
# ---------------------------------------------------------------------------

def test_ps_shard_serves_pub_verbs_to_a_subscriber(tmp_path, monkeypatch):
    """A publish-wired PS shard answers pub_latest / pub_list /
    pub_watch on its own endpoint: a VersionSubscriber watching that
    endpoint (kind ps-table, a swap_fn) sees every cadence version."""
    monkeypatch.setenv("PADDLE_TPU_DISABLE_NATIVE", "1")
    pub_dir = str(tmp_path / "pub")
    srv = PSServer("127.0.0.1:0", publish_dir=pub_dir,
                   publish_every_steps=2)
    srv.serve_in_thread()
    seen = []
    sub = VersionSubscriber(pub_dir, endpoint=srv.endpoint,
                            kinds=("ps-table",),
                            swap_fn=lambda v, rec: seen.append(
                                (v, rec["kind"])))
    sub.start()
    cl = PSClient([srv.endpoint])
    try:
        rng = np.random.RandomState(2)
        for round_ in range(2):
            for j in range(2):
                cl.push("emb", 4, np.arange(j * 3, j * 3 + 3),
                        rng.randn(3, 4))
            assert _wait_for(lambda: sub.current_version == round_ + 1)
        assert seen == [(1, "ps-table"), (2, "ps-table")]
        from paddle_tpu_torch.publish import RegistryClient
        rc = RegistryClient(srv.endpoint, timeout=30.0)
        try:
            lst = rc.list()
            assert [r["version"] for r in lst["versions"]] == [1, 2]
            assert rc.latest()["record"]["run"] == f"ps:{srv.endpoint}"
        finally:
            rc.close()
    finally:
        sub.stop()
        cl.close()
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# the launcher's --publish_dir
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_PROBE = ("import os\n"
          "print('PROBE', os.environ.get('TRAINING_ROLE', 'REPLICA'),\n"
          "      os.environ.get('PADDLE_TPU_PUBLISH_DIR', '-'), flush=True)\n")


def test_launcher_publish_dir_reaches_servers_and_replicas_only(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(_PROBE)
    pub = tmp_path / "pub"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_TPU_PUBLISH_DIR", None)
    launch = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
              "--publish_dir", str(pub)]
    logs_ps, logs_rep = tmp_path / "logs_ps", tmp_path / "logs_rep"
    p1, p2, p3 = _free_port(), _free_port(), _free_port()
    res = subprocess.run(
        launch + [f"--servers=127.0.0.1:{p1}",
                  f"--workers=127.0.0.1:{p2}", "--log_dir", str(logs_ps),
                  str(probe)],
        env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    res = subprocess.run(
        launch + [f"--serving_replicas=127.0.0.1:{p3}", "--log_dir",
                  str(logs_rep), str(probe)],
        env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    logs = {f: open(d / f).read() for d in (logs_ps, logs_rep)
            for f in os.listdir(d)}
    assert pub.is_dir()
    assert f"PROBE PSERVER {pub}" in logs["server.0.log"]
    assert "PROBE TRAINER -" in logs["worker.0.log"]
    assert f"PROBE REPLICA {pub}" in logs["replica.0.log"]
