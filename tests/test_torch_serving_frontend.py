"""The port's serving front end (paddle_tpu_torch/serving/frontend.py) over
its multiplexed wire, on the CPU, held to the JAX package:

  * the cases of tests/test_serving_frontend.py on the port's tiny GPT,
    whose weights come from the shared numpy init (one tree, both
    packages' models);
  * greedy tokens over the wire equal the JAX package's engine's for the
    same prompts (a token may differ only where JAX's top-2 logits tie
    within TIE_TOL), and equal the port's own in-process tokens exactly;
  * the JAX package's ServingClient against the port's ServingServer
    gives the same tokens, and the port's client against the JAX
    package's server the JAX engine's;
  * the verbs: streaming, ping / ping_info, stats, metrics,
    debug_dump, drain, adopt_version from the configured publish root,
    the handler timeout that cancels, seeded and seedless sampling that
    replays.

Size: hidden 128, 2 heads of 64, 2 layers, vocab 512, initializer range
0.5 (at 0.02 a tiny GPT repeats its last prompt token whatever its
weights, so tokens would prove nothing).
"""
import threading

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import GPTDecodeModel as JModel
from paddle_tpu.serving import ServingClient as JClient
from paddle_tpu.serving import ServingServer as JServer
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.distributed.fleet.runtime.rpc import PSRemoteError
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.serving import (Engine, GPTDecodeModel, ServingClient,
                                      ServingServer)

SIZE = dict(vocab_size=512, hidden_size=128, num_heads=2, num_layers=2,
            max_position_embeddings=128, initializer_range=0.5)
ENGINE_KW = dict(num_slots=4, num_pages=32, page_size=8, max_seq_len=64)
LOGIT_TOL = 1e-4
TIE_TOL = 2 * LOGIT_TOL
PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8], [100, 200, 300, 400, 500],
           [11], [42, 43, 44, 45, 46, 47, 48, 49, 50, 51]]
NEW = 7


@pytest.fixture(scope="module")
def models():
    cfg_j = jgpt.GPTConfig(**SIZE)
    cfg_p = pgpt.GPTConfig(**SIZE)
    tree = pgpt.init_gpt_params(cfg_p, seed=0)
    return (cfg_j, JModel(cfg_j, params=tree),
            GPTDecodeModel(cfg_p, params=tree, device="cpu"))


@pytest.fixture(scope="module")
def served(models):
    engine = Engine(models[2], **ENGINE_KW)
    with ServingServer(engine, "127.0.0.1:0") as srv:
        yield srv


@pytest.fixture(scope="module")
def jax_tokens(models):
    eng = JEngine(models[1], **ENGINE_KW)
    reqs = [eng.submit(p, NEW) for p in PROMPTS]
    eng.run_until_idle()
    return [r.result().tolist() for r in reqs]


@pytest.fixture(scope="module")
def port_tokens(models):
    eng = Engine(models[2], **ENGINE_KW)
    reqs = [eng.submit(p, NEW) for p in PROMPTS]
    eng.run_until_idle()
    return [r.result().tolist() for r in reqs]


@pytest.fixture(autouse=True)
def _clean_injector():
    fi.reset_injector(fi.FaultInjector())
    yield
    fi.reset_injector(fi.FaultInjector())


def _assert_greedy_parity(models, prompt, got, want):
    """Equal, or the first differing position is a tie of JAX's top-2
    logits within TIE_TOL (then either token is a correct argmax)."""
    if got == want:
        return
    cfg_j, jm, _ = models
    i = next(k for k in range(len(want)) if k >= len(got)
             or got[k] != want[k])
    ids = np.concatenate([prompt, want[:i]]).astype(np.int32)[None]
    logits = np.asarray(jgpt.gpt_forward(jm.params, jnp.asarray(ids),
                                         cfg_j))[0, -1]
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] < TIE_TOL, (prompt, got, want, top2)


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------

def test_frontend_generate_matches_reference(models, served, jax_tokens,
                                             port_tokens):
    cli = ServingClient(served.endpoint)
    try:
        assert cli.ping()
        for prompt, want_j, want_p in zip(PROMPTS, jax_tokens,
                                          port_tokens):
            rep = cli.generate(prompt, max_new_tokens=NEW, timeout=90)
            assert rep["status"] == "done"
            got = rep["tokens"].tolist()
            assert rep["tokens"].dtype == np.int32
            assert got == want_p
            _assert_greedy_parity(models, prompt, got, want_j)
            assert rep["prompt_len"] == len(prompt)
            assert rep["latency_ms"] > 0 and rep["trace_id"]
    finally:
        cli.close()
    # the tokens are not the degenerate repeat of the last prompt token
    assert any(len(set(t)) > 1 for t in port_tokens)


def test_frontend_stats_and_errors(served):
    cli = ServingClient(served.endpoint)
    try:
        st = cli.stats()
        assert st["num_slots"] == 4 and "compiles" in st
        assert st["pool"]["num_pages"] == 32
        rep = cli.generate([1] * 60, max_new_tokens=30, timeout=30)
        assert rep["status"] == "error" and "max_seq_len" in rep["error"]
        with pytest.raises(PSRemoteError, match="unknown op"):
            cli._rpc.call({"op": "nope"}, timeout=10)
    finally:
        cli.close()


def test_frontend_concurrent_clients(served, port_tokens):
    results = {}

    def one(i):
        cli = ServingClient(served.endpoint)
        try:
            results[i] = cli.generate(PROMPTS[i], max_new_tokens=NEW,
                                      timeout=90)
        finally:
            cli.close()

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert len(results) == len(PROMPTS)
    for i, rep in results.items():
        assert rep["status"] == "done"
        assert rep["tokens"].tolist() == port_tokens[i]


def test_one_shared_client_many_threads(served, port_tokens):
    """One ServingClient shared by many threads: calls interleave over
    the pooled channels (the multiplexed wire)."""
    cli = ServingClient(served.endpoint)
    out = {}
    try:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, cli.generate(PROMPTS[i], NEW, timeout=90)))
            for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        cli.close()
    assert [out[i]["tokens"].tolist() for i in range(len(PROMPTS))] \
        == port_tokens


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [False, True])
def test_jax_client_against_port_server(models, served, jax_tokens,
                                        port_tokens, stream):
    cli = JClient(served.endpoint)
    try:
        for prompt, want_j, want_p in zip(PROMPTS, jax_tokens,
                                          port_tokens):
            frames = []
            rep = cli.generate(prompt, NEW, timeout=90, stream=stream,
                               on_token=lambda t, i: frames.append((i, t)))
            assert rep["status"] == "done"
            got = rep["tokens"].tolist()
            assert got == want_p
            _assert_greedy_parity(models, prompt, got, want_j)
            if stream:
                assert [t for _, ts in frames for t in ts] == got
        assert cli.ping() and cli.ping_info()["ok"]
        assert "paddle_tpu_serving_tokens_total" in cli.metrics()
    finally:
        cli.close()


def test_port_client_against_jax_server(models, jax_tokens):
    eng = JEngine(models[1], **ENGINE_KW)
    with JServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            for prompt, want in zip(PROMPTS[:3], jax_tokens):
                frames = []
                rep = cli.generate(prompt, NEW, timeout=90, stream=True,
                                   on_token=lambda t, i: frames.extend(t))
                assert rep["status"] == "done"
                assert rep["tokens"].tolist() == want == frames
        finally:
            cli.close()


def test_ping_answers_the_jax_servers_keys(models, served):
    eng = JEngine(models[1], **ENGINE_KW)
    with JServer(eng, "127.0.0.1:0") as jsrv:
        jcli = JClient(jsrv.endpoint)
        try:
            want = jcli.ping_info()
        finally:
            jcli.close()
    cli = ServingClient(served.endpoint)
    try:
        got = cli.ping_info()
    finally:
        cli.close()
    assert set(got) == set(want)
    assert got["ok"] is True and got["draining"] is False
    assert isinstance(got["tokens_per_s_per_chip"], float)
    assert isinstance(got["mfu"], float)


# ---------------------------------------------------------------------------
# the verbs
# ---------------------------------------------------------------------------

def test_streamed_generate_reassembles_the_final_reply(served,
                                                       port_tokens):
    cli = ServingClient(served.endpoint)
    try:
        seen = []
        rep = cli.generate(PROMPTS[0], NEW, timeout=90, stream=True,
                           on_token=lambda toks, idx: seen.append(
                               (idx, list(toks))))
        flat = [t for _, ts in seen for t in ts]
        assert rep["status"] == "done"
        assert flat == rep["tokens"].tolist() == port_tokens[0]
        assert [i for i, _ in seen] == sorted(i for i, _ in seen)
    finally:
        cli.close()


def test_sampled_requests_replay_over_the_wire(models, served):
    cli = ServingClient(served.endpoint)
    try:
        kw = dict(temperature=0.9, top_k=20, top_p=0.95, seed=1234)
        a = cli.generate(PROMPTS[1], 10, timeout=90, **kw)
        b = cli.generate(PROMPTS[1], 10, timeout=90, **kw)
        assert a["tokens"].tolist() == b["tokens"].tolist()
        eng = Engine(models[2], **ENGINE_KW)
        r = eng.submit(PROMPTS[1], 10, **kw)
        eng.run_until_idle()
        assert a["tokens"].tolist() == r.result().tolist()
        # seedless: the stable wire id keys the stream, so a replay of
        # the same id (a retry, a failover) draws the same tokens
        rid = (0xBEEF << 32) | 5
        req = {"op": "generate", "prompt": np.asarray(PROMPTS[1],
                                                      np.int32),
               "max_new_tokens": 10, "temperature": 0.9, "timeout": 60}
        c = cli._rpc.call(dict(req), req_id=rid, timeout=90)
        d = cli._rpc.call(dict(req), req_id=rid, timeout=90)
        assert c["tokens"].tolist() == d["tokens"].tolist()
    finally:
        cli.close()


def test_debug_dump_and_metrics(served, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DEBUG_DIR", raising=False)
    cli = ServingClient(served.endpoint)
    try:
        cli.generate(PROMPTS[0], 2, timeout=90)
        b = cli.debug_dump(write=False)
        assert b["path"] is None and b["reason"] == "debug_dump"
        key = f"serving.engine.{served.engine.engine_id}"
        assert b["requests"][key]["num_slots"] == 4
        text = cli.metrics()
        for name in ("paddle_tpu_serving_tokens_total",
                     "paddle_tpu_rpc_server_requests_total",
                     "paddle_tpu_watchdog_checks_total"):
            assert name in text
    finally:
        cli.close()


def test_handler_timeout_cancels_the_request(models):
    """A wire timeout cancels the request (slot and pages freed) and
    replies with its partial tokens — the reply is dedup-cached, so a
    request still decoding would burn steps nobody can fetch."""
    eng = Engine(models[2], **ENGINE_KW)
    with ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            fi.reset_injector(fi.FaultInjector(
                stall=0.3, stall_point="serving_decode"))
            rep = cli.generate(PROMPTS[0], 30, timeout=0.5)
            assert rep["status"] == "timeout", rep
            assert len(rep["tokens"]) < 30
            fi.reset_injector(fi.FaultInjector())
            ok = cli.generate(PROMPTS[0], 3, timeout=60)
            assert ok["status"] == "done"
        finally:
            cli.close()
    assert eng.pool.stats()["used_pages"] == 0


def test_drain_then_reject(models):
    eng = Engine(models[2], **ENGINE_KW)
    with ServingServer(eng, "127.0.0.1:0") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            assert cli.generate(PROMPTS[0], 2, timeout=60)["status"] \
                == "done"
            rep = cli.drain(wait=True, timeout=30)
            assert rep["draining"] is True and rep["idle"] is True
            assert cli.ping_info()["draining"] is True
            assert cli.stats()["draining"] is True
            late = cli.generate(PROMPTS[0], 2, timeout=60)
            assert late["status"] == "rejected"
        finally:
            cli.close()


def test_adopt_version_from_the_configured_publish_root(models, tmp_path,
                                                        port_tokens):
    """adopt_version warm-starts from the server's publish root (the
    wire names only a version): a checkpoint of the served weights at
    step 3 keeps the tokens and stamps model_version 3; without a root
    configured the verb fails with a remote error."""
    root = str(tmp_path / "publish")
    models[2].save_checkpoint(root, step=3)
    zero = GPTDecodeModel(
        pgpt.GPTConfig(**SIZE),
        params=pgpt.init_gpt_params(pgpt.GPTConfig(**SIZE), seed=1),
        device="cpu")
    eng = Engine(zero, **ENGINE_KW)
    with ServingServer(eng, "127.0.0.1:0", publish_root=root) as srv:
        cli = ServingClient(srv.endpoint)
        try:
            rep = cli.adopt_version(3)
            assert rep == {"adopted": 3, "model_version": 3}
            assert cli.ping_info()["model_version"] == 3
            got = cli.generate(PROMPTS[0], NEW, timeout=90)
            assert got["tokens"].tolist() == port_tokens[0]
        finally:
            cli.close()
    eng2 = Engine(models[2], **ENGINE_KW)
    with ServingServer(eng2, "127.0.0.1:0", publish_root="") as srv:
        cli = ServingClient(srv.endpoint)
        try:
            with pytest.raises(PSRemoteError, match="no publish root"):
                cli.adopt_version(3)
        finally:
            cli.close()
