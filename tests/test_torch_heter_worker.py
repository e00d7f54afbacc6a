"""The port's heterogeneous PS tier (paddle_tpu_torch/distributed/fleet/
heter_worker.py): CPU sparse workers and a dense worker, held to the JAX
package's on the same seeded batches, over the wire both ways."""
import numpy as np
import pytest

from paddle_tpu.distributed.fleet import heter_worker as ref_hw
from paddle_tpu.distributed.fleet.runtime import fault_injection as ref_fi
from paddle_tpu.models.wide_deep import WideDeepConfig as RefConfig
from paddle_tpu_torch.distributed.fleet import heter_worker as hw
from paddle_tpu_torch.distributed.fleet.runtime import fault_injection as fi
from paddle_tpu_torch.models.wide_deep import WideDeepConfig

CFG = dict(vocab_size=128, num_slots=4, embed_dim=4, dense_dim=3,
           hidden=(16, 8))
RTOL, ATOL = 1e-4, 1e-6


def _batches(cfg, n, batch=32, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        ids = rng.randint(0, cfg.vocab_size, (batch, cfg.num_slots))
        dense = rng.randn(batch, cfg.dense_dim).astype("float32")
        label = ((ids < cfg.vocab_size // 2).mean(axis=1) > 0.5
                 ).astype("float32")[:, None]
        yield ids, dense, label


def _round_trip(dense_pkg, cpu_pkg, n):
    """A dense worker of `dense_pkg` serving a CPU worker of `cpu_pkg`
    (local KV) over TCP, n batches: losses, the dense parameters and
    the sparse rows after."""
    if dense_pkg == "port":
        dw = hw.HeterDenseWorker(WideDeepConfig(**CFG), "127.0.0.1:0",
                                 lr=0.1, device="cpu")
    else:
        dw = ref_hw.HeterDenseWorker(RefConfig(**CFG), "127.0.0.1:0",
                                     lr=0.1)
    dw.serve_in_thread()
    mod, cfg = (hw, WideDeepConfig(**CFG)) if cpu_pkg == "port" \
        else (ref_hw, RefConfig(**CFG))
    w = mod.HeterCpuWorker(cfg, dw.endpoint, ps_endpoints=None, lr=0.1)
    try:
        losses = [w.train_one_batch(*b) for b in _batches(cfg, n)]
        params = w.dense_params()
        rows = w._pull("embed", np.arange(cfg.vocab_size), cfg.embed_dim)
        wide = w._pull("wide", np.arange(cfg.vocab_size), 1)
        assert len(dw.losses) == n
    finally:
        w.stop_dense()
        w.close()
        dw.server_close()
    return losses, params, rows, wide


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    gp, wp = got[1], want[1]
    for k in ("wide_dense", "bias"):
        np.testing.assert_allclose(gp[k], wp[k], rtol=RTOL, atol=ATOL)
    for a, b in zip(gp["mlp"], wp["mlp"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL, atol=ATOL)


def test_heter_single_process_round_trip_matches_the_reference():
    """The JAX package's in-process smoke (dense worker thread + one CPU
    worker on a local KV): the loss drops, sparse rows move, and every
    loss, dense parameter and row stays within rtol 1e-4 of the
    reference's run on the same batches."""
    got = _round_trip("port", "port", 60)
    want = _round_trip("ref", "ref", 60)
    _close(got, want)
    losses = got[0]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.9
    init = hw.LargeScaleKV(4).pull(np.arange(CFG["vocab_size"]))
    assert np.abs(got[2] - init).max() > 0, "sparse tier never updated"


@pytest.mark.parametrize("dense_pkg,cpu_pkg", [("ref", "port"),
                                               ("port", "ref")])
def test_heter_wire_interop(dense_pkg, cpu_pkg):
    _close(_round_trip(dense_pkg, cpu_pkg, 15),
           _round_trip("ref", "ref", 15))


def test_dense_step_matches_the_reference_gradients():
    cfg = WideDeepConfig(**CFG)
    rng = np.random.RandomState(3)
    B = 16
    args = (rng.randn(B, cfg.num_slots * cfg.embed_dim).astype("float32"),
            rng.randn(B, 1).astype("float32"),
            rng.randn(B, cfg.dense_dim).astype("float32"),
            (rng.rand(B, 1) > 0.5).astype("float32"))
    dw = hw.HeterDenseWorker(cfg, "127.0.0.1:0", lr=0.1, seed=5,
                             device="cpu")
    ref = ref_hw.HeterDenseWorker(RefConfig(**CFG), "127.0.0.1:0", lr=0.1,
                                  seed=5)
    try:
        loss, d_emb, d_wide = dw.step(*args)
        rep = ref._step({"emb": args[0], "wide": args[1],
                         "dense": args[2], "label": args[3]})
        np.testing.assert_allclose(loss, rep["loss"], rtol=RTOL)
        np.testing.assert_allclose(d_emb, rep["d_emb"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(d_wide, rep["d_wide"], rtol=RTOL,
                                   atol=ATOL)
        got, want = dw.host_params(), ref._dispatch({"op": "params"})
        for a, b in zip(got["mlp"], want["mlp"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["bias"], want["bias"], rtol=RTOL,
                                   atol=ATOL)
        assert len(dw.step_seconds) == 1
    finally:
        dw.server_close()
        ref.server_close()


def test_dense_worker_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hw.HeterDenseWorker(WideDeepConfig(**CFG))


def test_heter_step_retries_are_exactly_once():
    """A CPU worker whose frames are corrupted retries "step"; the dense
    worker's dedup keeps every SGD update single-applied."""
    cfg = WideDeepConfig(**CFG)
    dw = hw.HeterDenseWorker(cfg, "127.0.0.1:0", lr=0.1, device="cpu")
    dw.serve_in_thread()
    fi.reset_injector(fi.FaultInjector(corrupt=0.1, side="client", seed=2))
    try:
        w = hw.HeterCpuWorker(cfg, dw.endpoint, ps_endpoints=None, lr=0.1)
        n = 20
        for b in _batches(cfg, n, batch=16):
            w.train_one_batch(*b)
        assert len(dw.losses) == n
        assert w.transport_stats["dense"]["retries"] > 0
    finally:
        fi.reset_injector(fi.FaultInjector())
        ref_fi.reset_injector(ref_fi.FaultInjector())
        w.stop_dense()
        w.close()
        dw.server_close()
