"""Activation recompute in the port (paddle_tpu_torch/distributed/
recompute.py, jit.TrainStep(remat=True)): the eager cases of
tests/test_recompute.py carried over, and the recomputed step held to
the plain one with dropout on (the seed stream, the autocast level and
the layer's parameters are put back for the rerun in the backward)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.recompute import recompute as j_recompute
from paddle_tpu.jit.functional import make_train_step as j_make_train_step
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed.recompute import (recompute,
                                                    wrap_layer_recompute)
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.nn import functional as F


def test_recompute_function_eager_passthrough():
    """tests/test_recompute.py's case: recompute(layer.forward, x) keeps
    the gradients flowing, and gives the reference's gradient."""
    paddle.disable_static()
    paddle.seed(0)
    jl = paddle.nn.Linear(4, 4)
    x = np.ones((2, 4), "float32")
    jy = j_recompute(jl.forward, paddle.to_tensor(x))
    paddle.sum(jy).backward()
    lin = pnn.Linear(4, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(jl.weight.numpy())))
        lin.bias.copy_(torch.from_numpy(np.asarray(jl.bias.numpy())))
    y = recompute(lin.forward, torch.from_numpy(x))
    y.sum().backward()
    assert lin.weight.grad is not None
    np.testing.assert_allclose(lin.weight.grad.numpy(),
                               np.asarray(jl.weight.grad.numpy()),
                               rtol=1e-6)
    with torch.no_grad():        # outside autograd: a plain call
        torch.testing.assert_close(recompute(lin, torch.ones(2, 4)),
                                   lin(torch.ones(2, 4)))


def test_recompute_replays_the_dropout_masks():
    """A segment with two dropouts under a seed stream: the rerun in the
    backward draws the same seeds, so the gradient is the plain one; the
    stream outside moves on as if the segment ran once."""
    torch.manual_seed(0)
    w = torch.randn(16, 16, requires_grad=True)
    x = torch.randn(8, 16)

    def seg(v):
        h = F.dropout(v @ w, 0.5)
        return F.dropout(torch.tanh(h) @ w, 0.3)

    grads, after = [], []
    for wrap in (False, True):
        with F.seed_scope(21):
            out = recompute(seg, x) if wrap else seg(x)
            after.append(F.next_seed())
        grads.append(torch.autograd.grad(out.square().sum(), w)[0])
    assert after[0] == after[1]
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def _bert(seed=3, drop=0.1):
    paddle.disable_static()
    paddle.seed(seed)
    jc = jbert.BertConfig.tiny()
    jc.hidden_dropout_prob = jc.attention_probs_dropout_prob = drop
    jm = jbert.BertForPretraining(jc)
    named = {n: p.numpy() for n, p in jm.named_parameters()}
    pm = pbert.BertForPretraining(pbert.BertConfig.tiny(
        hidden_dropout_prob=drop, attention_probs_dropout_prob=drop))
    pm.load_state_dict(pbert.params_from_jax(named), strict=True)
    return jm, pm


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(4, 1024, (2, 64)).astype("int64")
    mlm = np.full((2, 64), -100, "int64")
    mlm[:, ::5] = ids[:, ::5]
    nsp = rng.randint(0, 2, (2, 1)).astype("int64")
    return ids, mlm, nsp


def _loss_fn(m, ids, mlm, nsp):
    logits, nsp_logits = m(ids)
    return m.loss(logits, nsp_logits, mlm, nsp)


@pytest.mark.parametrize("amp", [None, "O1"])
def test_remat_step_gives_the_plain_loss_and_gradients(amp):
    """BERT tiny at dropout 0.1 (flash route, S = 64): remat=True against
    remat=False from the same weights and step seed, loss and every
    gradient; the encoder layers' forward runs twice under remat (the
    forward and its rerun), once without."""
    grads, losses, calls = [], [], []
    for remat in (False, True):
        _, pm = _bert()
        pm.train()
        step = make_train_step(pm, _loss_fn, amp_level=amp, device="cpu",
                               remat=remat)
        assert step.remat_layers == (2 if remat else 0)
        n = [0]
        layer = pm.bert.encoder.layers[0]
        hook = layer.register_forward_pre_hook(
            lambda *a: n.__setitem__(0, n[0] + 1))
        loss = step.loss(*_batch(), seed=5)
        g = torch.autograd.grad(loss, list(step.params.values()))
        hook.remove()
        losses.append(float(loss.detach()))
        grads.append(g)
        calls.append(n[0])
    assert calls == [1, 3]      # remat: the call, its functional_call, rerun
    assert losses[1] == losses[0]
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_train_step_remat_flag():
    """tests/test_recompute.py's case: TrainStep(remat=True) wraps the
    transformer layers, and three steps (dropout 0.1, seed 5) give the
    losses of the plain step, which the reference's own remat step
    matches within 2e-4."""
    def build(remat):
        _, pm = _bert(seed=0)
        pm.train()
        return make_train_step(pm, _loss_fn, optimizer="adamw", lr=1e-3,
                               device="cpu", remat=remat)

    plain, remat = build(False), build(True)
    assert remat.remat_layers > 0
    batch = _batch()
    l1 = [float(plain(*batch, seed=5)) for _ in range(3)]
    l2 = [float(remat(*batch, seed=5)) for _ in range(3)]
    np.testing.assert_allclose(l1, l2, rtol=2e-4)
    assert wrap_layer_recompute(remat.model) == 0        # idempotent


def test_remat_step_matches_the_reference_remat_step_without_dropout():
    """At dropout 0 the port's remat step and the reference's remat step
    (jax.checkpoint) give the same three losses."""
    jm, pm = _bert(seed=2, drop=0.0)
    jm.train(), pm.train()
    batch = _batch()
    kw = dict(optimizer="adamw", lr=1e-3, remat=True)
    jstep = j_make_train_step(jm, _loss_fn, donate=False, **kw)
    pstep = make_train_step(pm, _loss_fn, device="cpu", **kw)
    jl = [float(np.asarray(jstep(*batch)).ravel()[0]) for _ in range(3)]
    pl = [float(pstep(*batch)) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=2e-5)
