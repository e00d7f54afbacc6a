"""Data parallelism in the port (jit.TrainStep(mesh=), the executor's
data-parallel programs, the fleet facade's collective mode) at dp = 2,
two gloo processes on the CPU, against the JAX package's dp = 2 mesh
step on 2 of the 8 virtual CPU devices, on the same numpy inputs and
weights: BERT tiny (f32 and O1, shards holding different numbers of
masked positions), a conv-BN net in training mode (running statistics
included, shards with different channel means), the static regression
program of tests/test_data_parallel.py through
CompiledProgram.with_data_parallel and through fleet.minimize, a sparse
embedding's program through with_data_parallel, and
fleet.distributed_model. The port's workers (tests/torch_dp_workers.py)
import torch and the port only; every spawn is bounded by 60 s."""
import os
import pickle

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.jit.functional import make_train_step as j_make_train_step
from paddle_tpu.models import bert as jbert
import torch_dp_workers as W
from paddle_tpu_torch.distributed import spawn

TIMEOUT = 60
# the tolerances of tests/test_torch_bert.py's three-step AdamW case
BERT_LOSS = {None: 2e-5, "O1": 5e-3}
BERT_PARAM = {None: 1e-4, "O1": 6.5e-3}
STEP = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_vision.py's


def _spawn(tmp_path, case, *args):
    spawn(W.run, args=(case, str(tmp_path), *args), nprocs=2,
          timeout=TIMEOUT)
    out = []
    for r in range(2):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


# -- BERT tiny ----------------------------------------------------------------

CFG = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _bert_pair(seed=4):
    paddle.disable_static()
    paddle.seed(seed)
    jc = jbert.BertConfig.tiny()
    for k, v in CFG.items():
        setattr(jc, k, v)
    jm = jbert.BertForPretraining(jc)
    named = {n: p.numpy() for n, p in jm.named_parameters()}
    return jm, named


def _bert_batch():
    """A global batch of 4 sequences (2 a rank): rank 0's rows mask all 4
    positions, rank 1's ignore 3 of their 8, so the shards hold 8 and 5
    masked positions."""
    rng = np.random.RandomState(2)
    b, s, p = 4, 16, 4
    ids = rng.randint(4, 1024, (b, s)).astype("int64")
    pos = np.stack([np.sort(rng.choice(s, p, replace=False))
                    for _ in range(b)]).astype("int64")
    mlm = np.take_along_axis(ids, pos, axis=1)
    mlm[2, 1:] = -100
    nsp = rng.randint(0, 2, (b, 1)).astype("int64")
    return ids, pos, mlm, nsp


def _jloss(m, ids, pos, mlm, nsp):
    logits, nsp_logits = m(ids, masked_positions=pos)
    return m.loss(logits, nsp_logits, mlm, nsp)


def _reference_bert(amp, kw):
    jm, named = _bert_pair()
    jm.train()
    batch = _bert_batch()
    jstep = j_make_train_step(jm, _jloss, donate=False, mesh=_mesh2(),
                              amp_level=amp, **kw)
    losses = [float(np.asarray(jstep(*batch))) for _ in range(3)]
    jstep.write_back()
    return named, batch, losses, {n: p.numpy()
                                  for n, p in jm.named_parameters()}


KW = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01, grad_clip_norm=1.0)


@pytest.mark.parametrize("amp", [None, "O1"])
def test_bert_tiny_dp2_matches_the_reference_mesh_step(amp, tmp_path):
    named, batch, jl, jp = _reference_bert(amp, KW)
    mlm = batch[2]
    counts = [(mlm[:2] != -100).sum(), (mlm[2:] != -100).sum()]
    assert counts[0] != counts[1], counts          # 8 and 5
    res = _spawn(tmp_path, "bert_steps", named, CFG, batch,
                 dict(KW, amp_level=amp))
    for r, out in enumerate(res):
        assert out["dp"] == 2 and out["rank"] == r
        np.testing.assert_allclose(out["losses"], jl, rtol=BERT_LOSS[amp])
        for n, v in out["params"].items():
            d = np.abs(v - jp[n])
            assert d.max() <= BERT_PARAM[amp], (r, n, d.max())
    for n, v in res[0]["params"].items():       # the ranks stay equal
        np.testing.assert_array_equal(v, res[1]["params"][n], err_msg=n)


def test_averaging_per_rank_ratios_would_break_the_tolerance(tmp_path):
    """The control: with each rank's MLM mean over its own masked
    positions (the mean of per-rank ratios), the same f32 run misses
    the reference's first loss by more than ten times the tolerance
    above."""
    named, batch, jl, _ = _reference_bert(None, KW)
    res = _spawn(tmp_path, "bert_steps", named, CFG, batch, KW, 1, True)
    err = abs(res[0]["losses"][0] - jl[0]) / abs(jl[0])
    assert err > 10 * BERT_LOSS[None], err


# -- conv -> BN -> relu -> pool -> fc -----------------------------------------

def _conv_bn_batches():
    """Three global batches of 4 images (2 a rank); rank 1's images are
    shifted by +1.5, so the shards' per-channel means differ."""
    out = []
    for i in range(3):
        rs = np.random.RandomState(10 + i)
        img = rs.randn(4, 3, 8, 8).astype("float32")
        img[2:] += 1.5
        lab = rs.randint(0, 5, (4, 1)).astype("int64")
        out.append((img, lab))
    return out


def test_conv_bn_net_dp2_matches_the_reference_mesh_step(tmp_path):
    paddle.disable_static()
    paddle.seed(9)
    jm = W.conv_bn_net(jnn)
    jm.train()
    state = {n: np.asarray(p) for n, p in jm.state_dict().items()}
    batches = _conv_bn_batches()
    img = batches[0][0]
    m0, m1 = img[:2].mean((0, 2, 3)), img[2:].mean((0, 2, 3))
    assert np.abs(m0 - m1).min() > 1.0

    def xent(m, x, y):
        return paddle.nn.functional.cross_entropy(m(x), y)

    jstep = j_make_train_step(jm, xent, optimizer="momentum", lr=0.1,
                              donate=False, mesh=_mesh2())
    jl = [float(np.asarray(jstep(x, y)).ravel()[0]) for x, y in batches]
    jstep.write_back()
    want = {n: np.asarray(v) for n, v in jm.state_dict().items()}
    res = _spawn(tmp_path, "conv_bn_steps", state, batches, 2)
    assert any(n.endswith("_mean") for n in want)
    for out in res:
        np.testing.assert_allclose(out["losses"], jl, **STEP)
        assert out["state"].keys() == want.keys()
        for n, w in want.items():
            np.testing.assert_allclose(out["state"][n], w, err_msg=n, **STEP)


# -- static programs -----------------------------------------------------------

def _reference_regression(build=W.build_regression,
                          feeds=W.regression_feeds):
    """The reference's initial scope and its dp = 2 run of `build`'s
    program on `feeds` (the executor's mesh set to 2 devices for the
    run)."""
    from paddle_tpu import fluid
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.fluid import Executor
    from paddle_tpu.fluid.compiler import CompiledProgram
    from paddle_tpu.fluid.scope import Scope, scope_guard
    paddle.enable_static()
    try:
        main, startup, loss, sgd = build(fluid)
        # the optimizer's names from a fresh generator, as in the
        # workers' new processes, whatever ran before in this one
        with fluid.framework.program_guard(main, startup), \
                fluid.unique_name.guard():
            sgd.minimize(loss)
        prog = CompiledProgram(main).with_data_parallel(loss.name)
        prev = jmesh.get_mesh()
        jmesh.set_mesh(_mesh2())
        try:
            scope = Scope()
            with scope_guard(scope):
                exe = Executor()
                exe.run(startup)
                start = {n: np.asarray(scope.find_var(n)).copy()
                         for n in scope.local_var_names()}
                losses = [float(exe.run(prog, feed=f,
                                        fetch_list=[loss])[0][0])
                          for f in feeds()]
                params = {p.name: np.asarray(scope.find_var(p.name))
                          for p in main.all_parameters()}
        finally:
            jmesh._mesh = prev
    finally:
        paddle.disable_static()
    return start, losses, params


@pytest.fixture(scope="module")
def regression():
    return _reference_regression()


@pytest.mark.parametrize("how", ["compiled", "fleet"])
def test_static_program_dp2_matches_the_reference(regression, how,
                                                  tmp_path):
    """CompiledProgram.with_data_parallel and fleet's collective
    minimize: 20 SGD steps of the regression at dp = 2, losses within
    the reference's own dp tolerance (rtol 2e-3, atol 1e-4)."""
    start, jl, jp = regression
    assert jl[-1] < 0.2 * jl[0]
    res = _spawn(tmp_path, "static_dp", start, how)
    for r, out in enumerate(res):
        assert out["info"]["mode"] == "dp"
        np.testing.assert_allclose(out["losses"], jl, rtol=2e-3, atol=1e-4)
        for n, w in jp.items():
            np.testing.assert_allclose(out["params"][n], w, rtol=2e-3,
                                       atol=1e-4, err_msg=n)
        if how == "fleet":
            assert (out["worker_num"], out["worker_index"],
                    out["first"]) == (2, r, r == 0)


def test_sparse_embedding_dp2_matches_the_reference(tmp_path):
    """An is_sparse embedding through CompiledProgram.with_data_parallel
    at dp = 2: each rank's SelectedRows gradient is gathered over the
    ranks (rows and values of the whole batch, scaled by 1 / ranks), so
    20 SGD steps give the reference's dp = 2 losses and table within the
    data-parallel tolerance (rtol 2e-3, atol 1e-4); rows no batch looked
    up keep their start values exactly."""
    start, jl, jp = _reference_regression(W.build_sparse_regression,
                                          W.sparse_feeds)
    assert jl[-1] < 0.2 * jl[0]
    res = _spawn(tmp_path, "static_dp", start, "sparse")
    table = next(n for n in jp if jp[n].shape == (50, 8))
    for out in res:
        assert out["info"]["mode"] == "dp"
        np.testing.assert_allclose(out["losses"], jl, rtol=2e-3, atol=1e-4)
        for n, w in jp.items():
            np.testing.assert_allclose(out["params"][n], w, rtol=2e-3,
                                       atol=1e-4, err_msg=n)
        np.testing.assert_array_equal(out["params"][table][30:],
                                      start[table][30:])


def test_fleet_distributed_model_matches_the_reference(tmp_path):
    """fleet.distributed_model's forward equals the reference's
    DataParallel's on the same weights; scale_loss + backward +
    apply_collective_grads over two half batches gives the reference's
    gradient of the whole batch's mean loss."""
    from paddle_tpu.distributed.fleet.base.fleet_base import \
        _fleet as jfleet
    paddle.disable_static()
    paddle.seed(1)
    lin = jnn.Linear(8, 4)
    state = {n: np.asarray(p) for n, p in lin.state_dict().items()}
    x = np.random.RandomState(0).randn(6, 8).astype("float32")
    jfleet.init(is_collective=True)
    jmodel = jfleet.distributed_model(lin)
    jx = paddle.to_tensor(x)
    want_out = jmodel(jx).numpy()
    loss = jmodel.scale_loss(paddle.mean(paddle.square(jmodel(jx))))
    loss.backward()
    jmodel.apply_collective_grads()
    want = {n: p.grad.numpy() for n, p in lin.named_parameters()}
    res = _spawn(tmp_path, "fleet_model", state, x)
    for out in res:
        assert out["names"] == list(want)
        np.testing.assert_allclose(out["out"], want_out, rtol=1e-5,
                                   atol=1e-6)
        for n, w in want.items():
            np.testing.assert_allclose(out["grads"][n], w, rtol=1e-5,
                                       atol=1e-6, err_msg=n)


# -- dropout, and what raises ---------------------------------------------------

def test_dropout_masks_differ_across_ranks_and_p0_is_no_dropout(tmp_path):
    """p = 0.1 on the same rows on both ranks: the kept patterns differ
    (the rank is folded into the seed stream). p = 0: losses and
    parameters bit for bit those of the net without the dropout."""
    rng = np.random.RandomState(5)
    import torch
    torch.manual_seed(0)
    net = W.DropNet(None)
    state = {n: v.detach().clone() for n, v in net.state_dict().items()}
    row = rng.randn(1, 32).astype("float32")
    x = np.repeat(row, 4, axis=0)          # every rank sees the same rows
    for d in ("p01", "p0", "none"):
        (tmp_path / d).mkdir()
    drop = _spawn(tmp_path / "p01", "dropout_masks", state, 0.1, x)
    k0, k1 = drop[0]["kept"][0], drop[1]["kept"][0]
    assert k0.shape == k1.shape == (2, 64)
    assert not np.array_equal(k0, k1)
    assert 0.75 < k0.mean() < 0.99 and 0.75 < k1.mean() < 0.99
    p0 = _spawn(tmp_path / "p0", "dropout_masks", state, 0.0, x)
    none = _spawn(tmp_path / "none", "dropout_masks", state, None, x)
    assert p0[0]["losses"] == none[0]["losses"]
    for n, v in none[0]["params"].items():
        np.testing.assert_array_equal(p0[0]["params"][n], v, err_msg=n)


def test_a_batch_the_ranks_do_not_divide_raises(tmp_path):
    for msg in _spawn(tmp_path, "bad_batch"):
        assert msg is not None and "dp = 2" in msg
