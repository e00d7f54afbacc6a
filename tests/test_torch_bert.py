"""The BERT pretrain step of the port (paddle_tpu_torch: nn, amp,
models/bert.py, jit/functional.py) against the JAX package on BERT-tiny,
mirroring tests/test_transformer_bert.py: the reference's parameters are
carried across with params_from_jax (its initialisation goes through
jax.random, which the port can only match in distribution), the same
numpy batch goes through both, and logits, loss, every gradient and the
parameters after three train steps are compared, in float32 and under
AMP level O1.

Dropout: the reference derives its per-op seeds from jax.random key data,
which cannot be carried across, so the whole model is held to the
reference at dropout 0 and to itself (deterministic from the step seed,
different across steps) at dropout 0.1; each kernel-holding function is
held to its JAX counterpart at p > 0 with the same int32 seed in its own
test file. On the CPU every kernel wrapper takes its plain version."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.jit.functional import make_train_step as j_make_train_step
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.jit import TrainStep, make_train_step
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.nn import functional as F

B, S, P = 2, 16, 4
# float32: sums in another order than XLA's, through 2 layers
F32 = dict(atol=2e-5, rtol=2e-4)
# O1: both sides round the same values to bfloat16 at the same places
# (2**-8 relative a rounding); where f32 sums differ in their last bits a
# rounding can fall the other way, and a few such flips pass through the
# layers
O1 = dict(atol=3e-2, rtol=3e-2)


def _cfgs(**kw):
    kw.setdefault("hidden_dropout_prob", 0.0)
    kw.setdefault("attention_probs_dropout_prob", 0.0)
    jc = jbert.BertConfig.tiny()
    for k, v in kw.items():
        setattr(jc, k, v)
    return jc, pbert.BertConfig.tiny(**kw)


def _batch(vocab, seed=0, b=B, s=S, p=P):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, vocab, (b, s)).astype("int64")
    pos = np.stack([np.sort(rng.choice(s, p, replace=False))
                    for _ in range(b)]).astype("int64")
    mlm = np.take_along_axis(ids, pos, axis=1)
    nsp = rng.randint(0, 2, (b, 1)).astype("int64")
    return ids, pos, mlm, nsp


def _pair(seed=3, **kw):
    """(JAX model, port model) with the same parameters."""
    paddle.disable_static()
    paddle.seed(seed)
    jc, pc = _cfgs(**kw)
    jm = jbert.BertForPretraining(jc)
    pm = pbert.BertForPretraining(pc)
    named = {n: p.numpy() for n, p in jm.named_parameters()}
    missing, unexpected = pm.load_state_dict(
        pbert.params_from_jax(named), strict=True)
    assert not missing and not unexpected
    return jm, pm


def _loss_fn(m, ids, pos, mlm, nsp):
    logits, nsp_logits = m(ids, masked_positions=pos)
    return m.loss(logits, nsp_logits, mlm, nsp)


def _names(pm):
    return [n for n, _ in pm.named_parameters()]


def test_parameter_names_and_layouts_carry_across():
    jm, pm = _pair()
    jn = {n: tuple(p.shape) for n, p in jm.named_parameters()}
    pn = {n: tuple(p.shape) for n, p in pm.named_parameters()}
    assert jn == pn                      # the tied weight listed once
    assert pm.cls.decoder_weight is pm.bert.embeddings.word_embeddings.weight
    assert pm.bert.encoder.layers[0].linear1.weight.shape == (64, 128)


@pytest.mark.parametrize("amp", [None, "O1"])
def test_bert_tiny_forward_and_loss_match_jax(amp):
    jm, pm = _pair()
    jm.eval(), pm.eval()
    batch = _batch(1024)
    tol = O1 if amp else F32
    from paddle_tpu.amp.auto_cast import amp_guard as j_guard
    from paddle_tpu_torch.amp import amp_guard as p_guard
    import contextlib
    jcm = j_guard(True, level=amp) if amp else contextlib.nullcontext()
    pcm = p_guard(True, level=amp) if amp else contextlib.nullcontext()
    jt = [paddle.to_tensor(a) for a in batch]
    with jcm:
        jl, jn = jm(jt[0], masked_positions=jt[1])
        jloss = jm.loss(jl, jn, jt[2], jt[3])
    pt = [torch.from_numpy(a) for a in batch]
    with pcm, torch.no_grad():
        pl, pn = pm(pt[0], masked_positions=pt[1])
        ploss = pm.loss(pl, pn, pt[2], pt[3])
    assert pl.shape == (B * P, 1024) and pn.shape == (B, 2)
    assert pl.dtype == torch.float32
    np.testing.assert_allclose(pl.numpy(), jl.numpy(), **tol)
    np.testing.assert_allclose(pn.numpy(), jn.numpy(), **tol)
    np.testing.assert_allclose(float(ploss), float(jloss.numpy().ravel()[0]),
                               rtol=2e-3 if amp else 1e-5)


@pytest.mark.parametrize("amp", [None, "O1"])
def test_bert_tiny_gradients_match_jax(amp):
    """Every gradient of the pretrain loss. The JAX side reads them off
    one SGD step at lr 1 of its own make_train_step (gradient = before -
    after), which differentiates the jitted trace as the benchmark
    does."""
    jm, pm = _pair()
    jm.train(), pm.train()
    batch = _batch(1024, seed=1)
    before = {n: p.numpy().copy() for n, p in jm.named_parameters()}
    jstep = j_make_train_step(jm, _loss_fn, optimizer="sgd", lr=1.0,
                              donate=False, amp_level=amp)
    jloss = float(np.asarray(jstep(*batch)))
    jstep.write_back()
    jgrads = {n: before[n] - p.numpy() for n, p in jm.named_parameters()}
    pstep = make_train_step(pm, _loss_fn, amp_level=amp, device="cpu")
    loss = pstep.loss(*batch, seed=1)
    leaves = list(pstep.params.values())
    grads = dict(zip(pstep.params, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), jloss,
                               rtol=2e-3 if amp else 1e-5)
    assert set(grads) == set(jgrads)
    gmax = max(float(np.abs(w).max()) for w in jgrads.values())
    for n, g in grads.items():
        w = jgrads[n]
        # before - after carries the parameter's own rounding (2e-9 at
        # |p| ~ 0.02); O1 gradients carry bfloat16 roundings. A gradient
        # that is zero in exact arithmetic (a key projection's bias: the
        # softmax does not see it) is rounding noise of the gradients
        # around it, so no tolerance goes below 1% of the largest one
        scale = max(float(np.abs(w).max()), 1e-2 * gmax)
        np.testing.assert_allclose(
            g.numpy(), w, err_msg=n, rtol=0,
            atol=(5e-2 if amp else 5e-5) * scale)


@pytest.mark.parametrize("amp", [None, "O1"])
def test_three_train_steps_match_jax_train_step(amp):
    """AdamW with its own beta powers per parameter and the decay on
    every parameter, grad clip 1.0: losses and every parameter after
    three steps."""
    jm, pm = _pair(seed=4)
    jm.train(), pm.train()
    batch = _batch(1024, seed=2)
    kw = dict(optimizer="adamw", lr=1e-3, weight_decay=0.01,
              grad_clip_norm=1.0, amp_level=amp)
    jstep = j_make_train_step(jm, _loss_fn, donate=False, **kw)
    pstep = make_train_step(pm, _loss_fn, device="cpu", **kw)
    jl = [float(np.asarray(jstep(*batch))) for _ in range(3)]
    pl = [float(pstep(*batch)) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=5e-3 if amp else 2e-5)
    jstep.write_back()
    jp = {n: p.numpy() for n, p in jm.named_parameters()}
    for n, v in pstep.params.items():
        # three Adam steps of lr 1e-3 move a parameter by about 3e-3;
        # f32 agrees to a small share of one step. Under O1 a gradient
        # entry near zero (a key projection's bias has a zero gradient in
        # exact arithmetic) is bfloat16 rounding noise, which Adam
        # normalises to full steps in either direction on either side:
        # single entries may differ by both sides' whole way, the
        # parameter as a whole by a small share of it
        d = np.abs(v.detach().numpy() - jp[n])
        assert d.max() <= (6.5e-3 if amp else 1e-4), (n, d.max())
        if amp and not n.endswith("k_proj.bias"):
            assert d.mean() <= 5e-4, (n, d.mean())
    # the step leaves the model's own tensors alone until write_back()
    first = next(iter(pstep.params))
    own = dict(pm.named_parameters())[first]
    assert not torch.equal(own, pstep.params[first])
    pstep.write_back()
    assert torch.equal(own, pstep.params[first].detach())
    assert pm.cls.decoder_weight is pm.bert.embeddings.word_embeddings.weight


def test_padding_mask_matches_jax():
    """A 2-d (B, S) attention mask becomes the additive (B, 1, 1, S)
    mask of the attention op."""
    jm, pm = _pair()
    jm.eval(), pm.eval()
    ids = _batch(1024, seed=3)[0]
    am = np.ones((B, S), "int64")
    am[0, 10:] = 0
    am[1, 13:] = 0
    jl, jn = jm(paddle.to_tensor(ids), attention_mask=paddle.to_tensor(am))
    with torch.no_grad():
        pl, pn = pm(torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(am))
    np.testing.assert_allclose(pl.numpy(), jl.numpy(), **F32)
    np.testing.assert_allclose(pn.numpy(), jn.numpy(), **F32)


def test_masked_positions_head_matches_full_head():
    _, pm = _pair()
    pm.eval()
    ids, pos, _, _ = _batch(1024, seed=4)
    with torch.no_grad():
        full, _ = pm(torch.from_numpy(ids))
        got, _ = pm(torch.from_numpy(ids),
                    masked_positions=torch.from_numpy(pos))
    got = got.reshape(B, P, -1)
    for b in range(B):
        torch.testing.assert_close(got[b], full[b, pos[b]], rtol=1e-5,
                                   atol=1e-5)


# -- the three routes of each sub-layer of the encoder layer ---------------

ROUTES = {
    # fused_out_ln + fused_ffn_block (norm post): BERT's own layer
    "block_post": dict(activation="gelu", act_dropout=0.0),
    # fused_out_ln + composed _ffn + fused_dropout_add_ln: an activation
    # the block does not take
    "epilogue_act": dict(activation="tanh", act_dropout=0.0),
    # attention out-projection without bias: composed projection +
    # fused_dropout_add_ln; FFN composed + fused_dropout_add_ln
    "epilogue_nobias": dict(activation="relu", bias_attr=False),
    # pre-LN: layer_norm + residual adds, fused_ffn_block norm "pre"
    "pre_block": dict(activation="relu", normalize_before=True),
    # pre-LN with a composed FFN
    "pre_composed": dict(activation="tanh", normalize_before=True),
}


def _jgrad(t):
    g = t.gradient
    return np.asarray(g() if callable(g) else g)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encoder_layer_routes_match_jax(route, monkeypatch):
    kw = dict(ROUTES[route])
    paddle.disable_static()
    paddle.seed(5)
    jl = paddle.nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0, **kw)
    pl = pnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0, **kw)
    sd = {n: torch.from_numpy(p.numpy().copy())
          for n, p in jl.named_parameters()}
    pl.load_state_dict(sd, strict=True)
    jl.train(), pl.train()
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 32).astype(np.float32)
    dy = rng.randn(2, 8, 32).astype(np.float32)
    # which functional ops the port's layer goes through
    calls = []
    for name in ("fused_out_ln", "fused_ffn_block", "fused_dropout_add_ln"):
        orig = getattr(F, name)
        monkeypatch.setattr(
            F, name, lambda *a, _o=orig, _n=name, **k:
            (calls.append(_n), _o(*a, **k))[1])
    xt = torch.from_numpy(x).requires_grad_()
    y = pl(xt)
    want_calls = {
        "block_post": ["fused_out_ln", "fused_ffn_block"],
        "epilogue_act": ["fused_out_ln", "fused_dropout_add_ln"],
        "epilogue_nobias": ["fused_dropout_add_ln", "fused_dropout_add_ln"],
        "pre_block": ["fused_ffn_block"],
        "pre_composed": [],
    }[route]
    assert calls == want_calls
    grads = torch.autograd.grad(y, [xt, *pl.parameters()],
                                torch.from_numpy(dy))
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jy = jl(jx)
    np.testing.assert_allclose(y.detach().numpy(), jy.numpy(), atol=2e-5,
                               rtol=2e-5)
    jy.backward(paddle.to_tensor(dy))
    np.testing.assert_allclose(grads[0].numpy(), _jgrad(jx), atol=5e-5,
                               rtol=5e-4)
    jg = {n: _jgrad(p) for n, p in jl.named_parameters()}
    for (n, _), g in zip(pl.named_parameters(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), jg[n], err_msg=n, atol=5e-5,
                                   rtol=5e-4)


def test_encoder_stack_layers_do_not_share_parameters():
    enc = pnn.TransformerEncoder(
        pnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0), 3)
    ids = [id(p) for p in enc.parameters()]
    assert len(ids) == len(set(ids)) == 3 * len(list(
        enc.layers[0].parameters()))
    assert enc(torch.randn(2, 6, 32)).shape == (2, 6, 32)


# -- dropout ---------------------------------------------------------------

def test_dropout_is_deterministic_from_the_step_seed():
    """Dropout 0.1 everywhere, sequence 64 so that attention takes the
    flash route: the same step seed gives the same loss bit for bit,
    another seed another loss, and consecutive steps differ."""
    _, pm = _pair(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    pm.train()
    batch = _batch(1024, seed=7, b=2, s=64, p=8)
    step = make_train_step(pm, _loss_fn, lr=0.0, device="cpu")
    a = float(step.loss(*batch, seed=5))
    assert float(step.loss(*batch, seed=5)) == a
    assert float(step.loss(*batch, seed=6)) != a
    l1, l2 = float(step(*batch)), float(step(*batch))   # lr 0: same weights
    assert l1 != l2
    assert float(step(*batch, seed=1)) == l1            # step 1's own seed
    pm.eval()
    e = float(step.loss(*batch, seed=5))
    assert float(step.loss(*batch, seed=6)) == e        # no dropout in eval


def test_composed_ops_match_the_kernel_wrappers():
    """composed_ops() (the reference's PADDLE_TPU_DISABLE_PALLAS) swaps
    every kernel wrapper for its composed chain: same loss and the same
    gradients from the same step seed, dropout and flash route included."""
    _, pm = _pair(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    pm.train()
    batch = _batch(1024, seed=9, b=2, s=64, p=8)
    step = make_train_step(pm, _loss_fn, device="cpu")
    leaves = list(step.params.values())
    a = step.loss(*batch, seed=3)
    ga = torch.autograd.grad(a, leaves)
    with F.composed_ops():
        b = step.loss(*batch, seed=3)
        gb = torch.autograd.grad(b, leaves)
    np.testing.assert_allclose(float(a.detach()), float(b.detach()),
                               rtol=1e-6)
    gmax = max(float(g.abs().max()) for g in gb)
    for n, x, y in zip(step.params, ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=n, rtol=0,
                                   atol=1e-4 * gmax)


def test_op_seeds_are_distinct_int32():
    seeds = [F.op_seed(s, i) for s in range(1, 40) for i in range(1, 40)]
    assert len(set(seeds)) == len(seeds)
    assert all(-2 ** 31 <= s < 2 ** 31 for s in seeds)
    with F.seed_scope(3):
        inner = [F.next_seed(), F.next_seed()]
    assert inner == [F.op_seed(3, 1), F.op_seed(3, 2)]


def test_functional_dropout_modes_and_generator():
    x = torch.ones(4, 64)
    assert torch.equal(F.dropout(x, 0.3, training=False), x)
    torch.testing.assert_close(
        F.dropout(x, 0.3, training=False, mode="downgrade_in_infer"),
        x * 0.7)
    assert torch.equal(F.dropout(x, 1.0), torch.zeros_like(x))
    y = F.dropout(x, 0.25, seed=11)
    assert y.unique().tolist() == pytest.approx([0.0, 1.0 / 0.75])
    assert torch.equal(y, F.dropout(x, 0.25, seed=11))
    g1 = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(1))
    g2 = F.dropout(x, 0.25, generator=torch.Generator().manual_seed(1))
    assert torch.equal(g1, g2) and not torch.equal(g1, y)


# -- entry points, deferred arguments --------------------------------------

def test_entry_points_need_a_card_or_device_cpu():
    _, pm = _pair()
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(pm, _loss_fn)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(pm, _loss_fn, device="cuda")
    assert isinstance(make_train_step(pm, _loss_fn, device="cpu"), TrainStep)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh="dp1"), None), (dict(batch_spec="dp"), None),
    (dict(remat=True), None), (dict(optimizer="lamb"), None)])
def test_deferred_train_step_arguments_raise(kw, match):
    """mesh=, batch_spec=, remat= and optimizer="lamb" are ported
    (tests/test_torch_data_parallel.py, tests/test_torch_recompute.py,
    tests/test_torch_fluid_optimizers.py): here, on one rank, the step
    builds and trains, and a mesh that is not the port's raises."""
    from paddle_tpu_torch.distributed import make_mesh
    lin = pnn.Linear(4, 2)
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            make_train_step(lin, lambda m, x: m(x).sum(), device="cpu", **kw)
        return
    if kw.get("mesh") == "dp1":
        kw = dict(mesh=make_mesh({"dp": 1}))
        with pytest.raises(TypeError, match="make_mesh"):
            make_train_step(lin, lambda m, x: m(x).sum(), device="cpu",
                            mesh=object())
    step = make_train_step(lin, lambda m, x: m(x).sum(), device="cpu", **kw)
    assert step.dp == 1
    assert np.isfinite(float(step(np.ones((2, 4), np.float32))))


def test_bad_train_step_arguments_raise():
    lin = pnn.Linear(4, 2)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_train_step(lin, None, optimizer="adagradx", device="cpu")
    with pytest.raises(ValueError, match="amp_level"):
        make_train_step(lin, None, amp_level="O3", device="cpu")


def test_deferred_layers_and_caches_raise():
    for cls in (pnn.TransformerDecoderLayer, pnn.TransformerDecoder,
                pnn.Transformer):
        with pytest.raises(NotImplementedError, match="slice 4"):
            cls(32, 4, 64)
    with pytest.raises(NotImplementedError, match="need_weights"):
        pnn.MultiHeadAttention(32, 4, need_weights=True)
    mha = pnn.MultiHeadAttention(32, 4)
    layer = pnn.TransformerEncoderLayer(32, 4, 64)
    x = torch.zeros(1, 4, 32)
    with pytest.raises(NotImplementedError, match="slice 4"):
        mha(x, cache=object())
    with pytest.raises(NotImplementedError, match="slice 4"):
        mha.gen_cache(x)
    with pytest.raises(NotImplementedError, match="slice 4"):
        layer(x, cache=object())
    with pytest.raises(NotImplementedError, match="slice 4"):
        pnn.TransformerEncoder(layer, 1).gen_cache(x)
    with pytest.raises(NotImplementedError, match="slice 4"):
        pnn.TransformerEncoderLayer(32, 4, 64, activation="swish")


def test_fused_op_argument_handling():
    """The block ops' own handling: p = 0 outside training, missing LN
    scale / bias default to ones / zeros, an unknown activation raises
    ValueError."""
    rng = np.random.RandomState(8)
    x, res = (torch.from_numpy(rng.randn(2, 3, 32).astype(np.float32))
              for _ in range(2))
    w = torch.from_numpy(rng.randn(32, 32).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.randn(32).astype(np.float32) * 0.1)
    ev = F.fused_out_ln(x, w, b, res, dropout_p=0.5, training=False)
    want = torch.nn.functional.layer_norm(res + x @ w + b, (32,), eps=1e-5)
    torch.testing.assert_close(ev, want, atol=1e-5, rtol=1e-5)
    w1 = torch.from_numpy(rng.randn(32, 64).astype(np.float32) * 0.1)
    b1 = torch.zeros(64)
    w2 = torch.from_numpy(rng.randn(64, 32).astype(np.float32) * 0.1)
    out = F.fused_ffn_block(x, w1, b1, w2, b, res, activation="relu",
                            norm="none", dropout_p=0.5, training=False)
    torch.testing.assert_close(out, res + torch.relu(x @ w1) @ w2 + b,
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="gelu/gelu_tanh/relu"):
        F.fused_ffn_block(x, w1, b1, w2, b, res, activation="swish")


def test_amp_lists_and_guard():
    import importlib
    jac = importlib.import_module("paddle_tpu.amp.auto_cast")
    pac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
    assert pac.white_list == jac.white_list
    assert pac.black_list == jac.black_list
    x = torch.ones(2, 2)
    assert pac.autocast_inputs("matmul_v2", x)[0].dtype == torch.float32
    with pac.amp_guard(level="O1", custom_black_list=["gelu"]):
        assert pac.amp_level() == 1 and "gelu" in pac.black_list
        assert pac.autocast_inputs("matmul_v2", x)[0].dtype == torch.bfloat16
        assert pac.autocast_inputs(
            "layer_norm", x.bfloat16())[0].dtype == torch.float32
        assert pac.autocast_inputs("tanh", x)[0].dtype == torch.float32
        ids = torch.zeros(2, dtype=torch.long)
        assert pac.autocast_inputs("matmul_v2", ids, None) == (ids, None)
    assert pac.amp_level() == 0 and "gelu" not in pac.black_list
    with pac.amp_guard(level="O2"):
        assert pac.autocast_inputs("tanh", x)[0].dtype == torch.bfloat16
        assert pac.autocast_inputs("softmax", x)[0].dtype == torch.float32
    with pytest.raises(ValueError, match="O1"):
        with pac.amp_guard(level="O3"):
            pass


def test_bert_flops_count_matches_bench():
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "bench", pathlib.Path(__file__).resolve().parents[1] / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from paddle_tpu_torch.observability.perf import bert_train_flops_per_step
    for cfg, b, s, n in ((pbert.BertConfig.base(), 16, 128, 19),
                         (pbert.BertConfig.tiny(), 4, 32, None)):
        assert bert_train_flops_per_step(cfg, b, s, n) \
            == bench.bert_train_flops_per_step(cfg, b, s, n)
