"""The vision slice of the port (paddle_tpu_torch: nn conv / pool /
batch-norm layers and functions, the momentum and sgd updates,
models/{resnet,vgg,mobilenet,lenet}.py, jit/functional.py) against the
JAX package on the CPU.

Inputs come from numpy with a seed and go through both packages. The
reference initialises its layers through jax.random, which the port can
only match in distribution, so each model's parameters AND batch-norm
running statistics are carried across with ``params_from_jax``.
Tolerances: float32 1e-5 for single ops (5e-5 where a convolution's
sums run in another order), 2e-4 through whole models (as
tests/test_vision_models.py holds NHWC to NCHW), 1e-4 after three train
steps; bfloat16 inputs 2e-2 (one bfloat16 rounding is 2**-8 relative).

Dropout masks come from jax.random in the reference and from the port's
counter hash, so the whole-model comparisons set the Dropout layers of
both models to p = 0 (calling eval() on one reference sublayer would
switch every batch norm of the reference to its running statistics: its
tracer's mode is global)."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.fluid.executor import ExecContext
from paddle_tpu.jit.functional import make_train_step as j_make_train_step
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.vision import models as jmodels

import paddle_tpu_torch.fluid.ops  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch import common_ops, nn as pnn
from paddle_tpu_torch.amp import amp_guard
from paddle_tpu_torch.fluid import registry as preg
from paddle_tpu_torch.jit import TrainStep, make_train_step
from paddle_tpu_torch.models import resnet as presnet
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability.perf import resnet_train_flops_per_step
from paddle_tpu_torch.vision import models as pmodels

F32 = dict(rtol=1e-5, atol=1e-5)
CONV = dict(rtol=5e-5, atol=5e-5)
MODEL = dict(rtol=2e-4, atol=2e-4)
STEP = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _jt(a):
    return paddle.to_tensor(np.asarray(a))


# -- conv2d and the pools ----------------------------------------------------

CONV_CASES = {
    "stride2-int-pad": dict(stride=2, padding=1),
    "list4-pad": dict(stride=1, padding=[1, 2, 0, 1]),
    "same-stride2": dict(stride=2, padding="SAME"),
    "valid-dilation2": dict(stride=1, padding="VALID", dilation=2),
    "groups2": dict(stride=1, padding=1, groups=2),
    "depthwise": dict(stride=2, padding=1, groups=4),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case, fmt):
    kw = CONV_CASES[case]
    rs = np.random.RandomState(0)
    g = kw.get("groups", 1)
    x = rs.randn(2, 4, 11, 9).astype("float32")
    w = rs.randn(6 if g != 4 else 8, 4 // g, 3, 3).astype("float32")
    b = rs.randn(w.shape[0]).astype("float32")
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    paddle.disable_static()
    ref = JF.conv2d(_jt(x), _jt(w), _jt(b), data_format=fmt, **kw).numpy()
    got = F.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                   data_format=fmt, **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), ref, **CONV)


POOL_CASES = {
    "max-k3s2p1": (F.max_pool2d, JF.max_pool2d,
                   dict(kernel_size=3, stride=2, padding=1)),
    "max-k2-ceil": (F.max_pool2d, JF.max_pool2d,
                    dict(kernel_size=2, ceil_mode=True)),
    "avg-exclusive-k3s2p1": (F.avg_pool2d, JF.avg_pool2d,
                             dict(kernel_size=3, stride=2, padding=1)),
    "avg-inclusive-k3s2p1": (F.avg_pool2d, JF.avg_pool2d,
                             dict(kernel_size=3, stride=2, padding=1,
                                  exclusive=False)),
    "avg-k2s2": (F.avg_pool2d, JF.avg_pool2d, dict(kernel_size=2, stride=2)),
    "adaptive-avg-4x3": (F.adaptive_avg_pool2d, JF.adaptive_avg_pool2d,
                         dict(output_size=(4, 3))),
    "adaptive-avg-1x1": (F.adaptive_avg_pool2d, JF.adaptive_avg_pool2d,
                         dict(output_size=1)),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pools_match_jax(case, fmt):
    fn, jfn, kw = POOL_CASES[case]
    x = np.random.RandomState(1).randn(2, 5, 13, 9).astype("float32")
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    paddle.disable_static()
    ref = jfn(_jt(x), data_format=fmt, **kw).numpy()
    got = fn(torch.tensor(x), data_format=fmt, **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), ref, **F32)


@pytest.mark.parametrize("size", [(3, 3), (4, 2), 1])
def test_adaptive_max_pool_matches_jax(size):
    x = np.random.RandomState(2).randn(2, 3, 8, 7).astype("float32")
    paddle.disable_static()
    ref = JF.adaptive_max_pool2d(_jt(x), size).numpy()
    np.testing.assert_allclose(
        _np(F.adaptive_max_pool2d(torch.tensor(x), size)), ref, **F32)


def test_nhwc_pool_and_conv_keep_channels_last_memory():
    """An NHWC tensor reaches torch's convolution and pooling as a
    channels-last NCHW view, and their results come back NHWC-contiguous:
    no layout copy between the layers of an NHWC trunk."""
    x = torch.randn(2, 9, 10, 4)
    w = torch.randn(6, 4, 3, 3)
    y = F.conv2d(x, w, padding=1, data_format="NHWC")
    z = F.max_pool2d(y, 3, 2, 1, data_format="NHWC")
    a = F.adaptive_avg_pool2d(z, 1, data_format="NHWC")
    for t in (y, z, a):
        assert t.is_contiguous(), t.stride()


# -- batch norm -------------------------------------------------------------

def _bn_inputs(fmt, dtype, seed=0):
    rs = np.random.RandomState(seed)
    shape = (4, 6, 5, 3) if fmt == "NCHW" else (4, 5, 3, 6)
    # a mean far from zero: the shifted single-pass statistics matter
    x = (rs.randn(*shape) * 1.5 + 3.0).astype("float32")
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    c = 6
    return dict(x=x, scale=rs.uniform(0.5, 1.5, c).astype("float32"),
                bias=rs.randn(c).astype("float32"),
                mean=rs.randn(c).astype("float32"),
                var=rs.uniform(0.5, 2.0, c).astype("float32"),
                dy=rs.randn(*shape).astype("float32"))


def _jax_bn(d, fmt, dtype, is_test):
    """Y, MeanOut, VarianceOut and (dx, dscale, dbias) from jax.vjp of
    the reference's batch_norm op."""
    opdef = jreg.require("batch_norm")
    attrs = dict(momentum=0.9, epsilon=1e-5, is_test=is_test,
                 data_layout=fmt)
    opdef.fill_default_attrs(attrs)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ctx = ExecContext(jax.random.PRNGKey(0), is_test=is_test)

    def f(x, scale, bias):
        outs = opdef.compute(ctx, {
            "X": [x], "Scale": [scale], "Bias": [bias],
            "Mean": [jnp.asarray(d["mean"])],
            "Variance": [jnp.asarray(d["var"])]}, dict(attrs))
        return outs["Y"][0], (outs["MeanOut"][0], outs["VarianceOut"][0])

    y, vjp, (mo, vo) = jax.vjp(f, jnp.asarray(d["x"], jdt),
                               jnp.asarray(d["scale"]),
                               jnp.asarray(d["bias"]), has_aux=True)
    grads = vjp(jnp.asarray(d["dy"], jdt))
    return y, mo, vo, grads


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_op_matches_jax_vjp(fmt, dtype, is_test):
    """The port's registered batch_norm op (the body F.batch_norm runs)
    against jax.vjp of the reference's: Y, MeanOut, VarianceOut, dx,
    dscale and dbias."""
    d = _bn_inputs(fmt, dtype)
    jy, jmo, jvo, (jdx, jds, jdb) = _jax_bn(d, fmt, dtype, is_test)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = torch.tensor(d["x"]).to(tdt).requires_grad_()
    scale = torch.tensor(d["scale"]).requires_grad_()
    bias = torch.tensor(d["bias"]).requires_grad_()
    outs = preg.require("batch_norm").compute(None, {
        "X": [x], "Scale": [scale], "Bias": [bias],
        "Mean": [torch.tensor(d["mean"])],
        "Variance": [torch.tensor(d["var"])]}, dict(
            momentum=0.9, epsilon=1e-5, is_test=is_test, data_layout=fmt))
    y = outs["Y"][0]
    assert y.dtype == tdt
    dx, ds, db = torch.autograd.grad(y, (x, scale, bias),
                                     torch.tensor(d["dy"]).to(tdt))
    assert dx.dtype == tdt and ds.dtype == db.dtype == torch.float32
    tol = BF16 if dtype == "bfloat16" else F32
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    # the statistics are float32 in both, whatever x's type
    np.testing.assert_allclose(_np(outs["MeanOut"][0]), _np(jmo), **F32)
    np.testing.assert_allclose(_np(outs["VarianceOut"][0]), _np(jvo), **F32)
    np.testing.assert_allclose(_np(dx), _np(jdx), **tol)
    if dtype == "bfloat16" and is_test:
        # eval in bfloat16: the reference differentiates its bfloat16
        # arithmetic, and XLA sums dscale and dbias (60 terms each) in
        # bfloat16, where torch sums them in float32 and rounds once;
        # both are held to float64 sums of the same bfloat16 inputs,
        # each within 2e-2 of that sum's largest element
        xd = d["x"].astype(np.float64)
        dyd = np.asarray(torch.tensor(d["dy"]).to(tdt).double())
        caxis = 1 if fmt == "NCHW" else 3
        axes = tuple(i for i in range(4) if i != caxis)
        c = [1] * 4
        c[caxis] = 6
        inv = 1.0 / np.sqrt(d["var"].astype(np.float64) + 1e-5)
        exact = {"ds": (dyd * (xd - d["mean"].reshape(c))).sum(axes) * inv,
                 "db": dyd.sum(axes)}
        for name, got_, ref_ in (("ds", ds, jds), ("db", db, jdb)):
            scale_tol = dict(rtol=2e-2, atol=2e-2 * np.abs(exact[name]).max())
            np.testing.assert_allclose(_np(got_), exact[name], **scale_tol)
            np.testing.assert_allclose(_np(ref_), exact[name], **scale_tol)
        return
    np.testing.assert_allclose(_np(ds), _np(jds), **tol)
    np.testing.assert_allclose(_np(db), _np(jdb), **tol)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_grad_op_matches_jax_vjp(fmt):
    """The static graph's synthesised batch_norm_grad op re-runs the
    forward under autograd and so reaches the same hand-written
    backward."""
    d = _bn_inputs(fmt, "float32", seed=1)
    _, _, _, (jdx, jds, jdb) = _jax_bn(d, fmt, "float32", False)
    t = {k: torch.tensor(v) for k, v in d.items()}
    outs = preg.require("batch_norm_grad").compute(None, {
        "X": [t["x"]], "Scale": [t["scale"]], "Bias": [t["bias"]],
        "Mean": [t["mean"]], "Variance": [t["var"]],
        "Y@GRAD": [t["dy"]]}, dict(momentum=0.9, epsilon=1e-5,
                                   is_test=False, data_layout=fmt))
    np.testing.assert_allclose(_np(outs["X@GRAD"][0]), _np(jdx), **F32)
    np.testing.assert_allclose(_np(outs["Scale@GRAD"][0]), _np(jds), **F32)
    np.testing.assert_allclose(_np(outs["Bias@GRAD"][0]), _np(jdb), **F32)
    # the running statistics get no gradient
    assert not outs["Mean@GRAD"][0].any()


def _torch_running_stats(d, fmt):
    """What torch.nn.functional.batch_norm leaves in its running
    buffers for the same call (momentum 0.1 in torch's convention)."""
    rm, rv = torch.tensor(d["mean"]), torch.tensor(d["var"])
    x = torch.tensor(d["x"])
    if fmt == "NHWC":
        x = x.permute(0, 3, 1, 2)
    torch.nn.functional.batch_norm(x, rm, rv, torch.tensor(d["scale"]),
                                   torch.tensor(d["bias"]), training=True,
                                   momentum=0.1, eps=1e-5)
    return rm.numpy(), rv.numpy()


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_running_stats_are_the_references_not_torchs(fmt):
    """F.batch_norm writes the reference's running statistics into the
    buffers it was given (biased variance, m = 0.9 keeps 90% of the old
    value). torch's own update (unbiased variance) gives other buffers,
    by far more than the tolerance this check holds the port to."""
    d = _bn_inputs(fmt, "float32", seed=2)
    _, jmo, jvo, _ = _jax_bn(d, fmt, "float32", False)
    rm, rv = torch.tensor(d["mean"]), torch.tensor(d["var"])
    F.batch_norm(torch.tensor(d["x"]), rm, rv, torch.tensor(d["scale"]),
                 torch.tensor(d["bias"]), training=True, data_format=fmt)
    np.testing.assert_allclose(rm.numpy(), _np(jmo), **F32)
    np.testing.assert_allclose(rv.numpy(), _np(jvo), **F32)
    tm, tv = _torch_running_stats(d, fmt)
    np.testing.assert_allclose(tm, _np(jmo), **F32)   # the mean agrees
    assert not np.allclose(tv, _np(jvo), **F32)       # the variance not
    # eval leaves the buffers alone
    before = rm.clone()
    F.batch_norm(torch.tensor(d["x"]), rm, rv, torch.tensor(d["scale"]),
                 torch.tensor(d["bias"]), training=False, data_format=fmt)
    assert torch.equal(rm, before)


def test_batch_norm_under_o1_keeps_float32_state():
    """Under O1 batch_norm is on neither list: a bfloat16 X stays
    bfloat16 and so does Y; under O2 X is cast but Mean, Variance, Scale
    and Bias stay float32 (_KEEP_F32_SLOTS)."""
    d = _bn_inputs("NHWC", "float32")
    for level, x in (("O1", torch.tensor(d["x"]).bfloat16()),
                     ("O2", torch.tensor(d["x"]))):
        rm, rv = torch.tensor(d["mean"]), torch.tensor(d["var"])
        with amp_guard(True, level=level):
            y = F.batch_norm(x, rm, rv, torch.tensor(d["scale"]),
                             torch.tensor(d["bias"]), training=True,
                             data_format="NHWC")
        assert y.dtype == torch.bfloat16
        assert rm.dtype == rv.dtype == torch.float32
        assert not torch.equal(rm, torch.tensor(d["mean"]))


def test_batch_norm_run_op_updates_nothing_in_place():
    """The op (static graph, run_op) returns new running statistics; only
    the eager function writes them into its buffers."""
    d = _bn_inputs("NCHW", "float32")
    t = {k: torch.tensor(v) for k, v in d.items()}
    res = common_ops.run_op_multi(
        "batch_norm", {"X": t["x"], "Scale": t["scale"], "Bias": t["bias"],
                       "Mean": t["mean"], "Variance": t["var"]},
        {"momentum": 0.9, "epsilon": 1e-5, "is_test": False},
        {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
         "SavedVariance": 1})
    assert torch.equal(t["mean"], torch.tensor(d["mean"]))
    _, jmo, _, _ = _jax_bn(d, "NCHW", "float32", False)
    np.testing.assert_allclose(_np(res["MeanOut"][0]), _np(jmo), **F32)


# -- the momentum and sgd updates --------------------------------------------

@pytest.mark.parametrize("l2", [False, True], ids=["plain", "l2_decay"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_op_matches_jax(nesterov, l2):
    rs = np.random.RandomState(3)
    p, g, v = (rs.randn(7, 5).astype("float32") for _ in range(3))
    lr = np.asarray([0.1], "float32")
    attrs = {"mu": 0.9, "use_nesterov": nesterov,
             "regularization_method": "l2_decay" if l2 else "",
             "regularization_coeff": 0.05 if l2 else 0.0}
    ref = jreg.require("momentum").compute(None, {
        "Param": [jnp.asarray(p)], "Grad": [jnp.asarray(g)],
        "Velocity": [jnp.asarray(v)], "LearningRate": [jnp.asarray(lr)]},
        dict(attrs))
    tp, tv = torch.tensor(p), torch.tensor(v)
    got = preg.require("momentum").compute(None, {
        "Param": [tp], "Grad": [torch.tensor(g)], "Velocity": [tv],
        "LearningRate": [torch.tensor(lr)]}, dict(attrs))
    assert got["ParamOut"][0] is tp and got["VelocityOut"][0] is tv
    np.testing.assert_allclose(tp.numpy(), _np(ref["ParamOut"][0]), **F32)
    np.testing.assert_allclose(tv.numpy(), _np(ref["VelocityOut"][0]), **F32)


def test_sgd_op_matches_jax_and_sparse_grads_raise():
    rs = np.random.RandomState(4)
    p, g = rs.randn(6, 3).astype("float32"), rs.randn(6, 3).astype("float32")
    lr = np.asarray([0.3], "float32")
    ref = jreg.require("sgd").compute(None, {
        "Param": [jnp.asarray(p)], "Grad": [jnp.asarray(g)],
        "LearningRate": [jnp.asarray(lr)]}, {})
    tp = torch.tensor(p)
    preg.require("sgd").compute(None, {
        "Param": [tp], "Grad": [torch.tensor(g)],
        "LearningRate": [torch.tensor(lr)]}, {})
    np.testing.assert_allclose(tp.numpy(), _np(ref["ParamOut"][0]), **F32)
    # sgd and momentum take SelectedRows gradients now
    # (tests/test_torch_selected_rows.py); the update ops without a
    # sparse rule raise on one, as the reference's fail
    from paddle_tpu_torch.fluid.selected_rows import SelectedRows
    sr = SelectedRows(torch.tensor([1, 1, 4]), torch.tensor(g[:3]), 6)
    for op in ("adagrad", "rmsprop"):
        with pytest.raises(NotImplementedError, match="dense gradient"):
            preg.require(op).compute(None, {
                "Param": [tp], "Grad": [sr], "Moment": [tp],
                "MeanSquare": [tp], "LearningRate": [torch.tensor(lr)]},
                {"epsilon": 1e-6, "decay": 0.9, "momentum": 0.0,
                 "centered": False})


# -- whole models: forward parity --------------------------------------------

def _pair(build_j, build_p, seed=5):
    """(JAX model, port model) with the same parameters and buffers."""
    paddle.disable_static()
    paddle.seed(seed)
    jm, pm = build_j(), build_p()
    sd = presnet.params_from_jax(
        {n: p.numpy() for n, p in jm.named_parameters()},
        {n: b.numpy() for n, b in jm.named_buffers()})
    missing, unexpected = pm.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    return jm, pm


def _no_dropout(m):
    for sub in m.sublayers() if hasattr(m, "sublayers") else m.modules():
        if type(sub).__name__ == "Dropout":
            sub.p = 0.0


MODELS = {
    "resnet18-NCHW": (lambda p: p.resnet18(num_classes=10), (2, 3, 64, 64)),
    "resnet18-NHWC": (lambda p: p.resnet18(num_classes=10,
                                           data_format="NHWC"),
                      (2, 3, 64, 64)),
    "resnet50-32px-batch1": (lambda p: p.resnet50(num_classes=7),
                             (1, 3, 32, 32)),
    "resnet18-backbone": (lambda p: p.resnet18(num_classes=0,
                                               with_pool=False),
                          (2, 3, 64, 64)),
    "vgg11": (lambda p: p.vgg11(num_classes=5), (1, 3, 32, 32)),
    "mobilenet_v1": (lambda p: p.mobilenet_v1(scale=0.25, num_classes=6),
                     (2, 3, 64, 64)),
    "mobilenet_v2": (lambda p: p.mobilenet_v2(scale=0.25, num_classes=6),
                     (2, 3, 64, 64)),
    "lenet": (lambda p: p.LeNet(), (2, 1, 28, 28)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_forward_matches_jax(name):
    """Eval mode (the carried running statistics), then train mode (batch
    statistics), then the running statistics that the train-mode forward
    left behind. (resnet50 at 32 x 32 and batch 1 normalises its last
    stage over one value a channel in train mode: zeros on both sides.)

    A running variance comes from the reference's single-pass statistics,
    E[(x - shift)^2] - d^2, which cancel in float32 where a channel's
    mean dwarfs its spread (resnet50's third stage at batch 1 sees 4
    values a channel); where the two packages' float32 sums then differ
    by more than 2e-4, the port's largest error from the same forward run
    in float64 must be within twice the reference's."""
    build, shape = MODELS[name]
    jm, pm = _pair(lambda: build(jmodels), lambda: build(pmodels))
    _no_dropout(jm), _no_dropout(pm)
    p64 = copy.deepcopy(pm).double().train()
    x = np.random.RandomState(6).randn(*shape).astype("float32")
    for mode in ("eval", "train"):
        getattr(jm, mode)(), getattr(pm, mode)()
        ref = jm(_jt(x)).numpy()
        with torch.no_grad():
            got = pm(torch.tensor(x))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, **MODEL)
    with torch.no_grad():
        p64(torch.tensor(x, dtype=torch.float64))
    jb = {n: b.numpy() for n, b in jm.named_buffers()}
    pb, b64 = dict(pm.named_buffers()), dict(p64.named_buffers())
    assert set(jb) == set(pb)
    for n, v in jb.items():
        got, exact = pb[n].numpy(), b64[n].numpy()
        if not np.allclose(got, v, **MODEL):
            err, ref_err = np.abs(got - exact).max(), np.abs(v - exact).max()
            assert err <= 2 * ref_err, (n, err, ref_err)


def test_backbone_shape_and_nhwc_stem():
    """Backbone mode returns the last feature map ([B, 512, H/32, W/32]
    NCHW); an NHWC ResNet turns an NCHW input into NHWC memory once at
    the stem, and its stem output is NHWC-contiguous."""
    m = pmodels.resnet18(num_classes=0, with_pool=False).eval()
    assert tuple(m(torch.randn(2, 3, 64, 64)).shape) == (2, 512, 2, 2)
    m = pmodels.resnet18(num_classes=0, with_pool=False,
                         data_format="NHWC").eval()
    seen = []
    m.stem[0].register_forward_hook(lambda mod, i, o: seen.append(o))
    out = m(torch.randn(2, 3, 64, 64))
    assert tuple(out.shape) == (2, 2, 2, 512) and out.is_contiguous()
    assert seen[0].shape == (2, 32, 32, 64) and seen[0].is_contiguous()


# -- the momentum train step -------------------------------------------------

def _small_net(pkg_nn, resnet, df, to_nhwc):
    """A stem, one BottleneckBlock with a downsample, a pool and an fc,
    built from either package's layers; `to_nhwc` turns the NCHW batch
    into NHWC for an NHWC net."""

    class Net(pkg_nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = pkg_nn.Sequential(
                pkg_nn.Conv2D(3, 8, 3, stride=2, padding=1, bias_attr=False,
                              data_format=df),
                pkg_nn.BatchNorm2D(8, data_format=df), pkg_nn.ReLU(),
                pkg_nn.MaxPool2D(3, 2, 1, data_format=df))
            down = resnet._conv_bn(8, 16, 1, 2, act=False, data_format=df)
            self.block = resnet.BottleneckBlock(8, 4, 2, down,
                                                data_format=df)
            self.pool = pkg_nn.AdaptiveAvgPool2D((1, 1), data_format=df)
            self.flatten = pkg_nn.Flatten()
            self.fc = pkg_nn.Linear(16, 5)

        def forward(self, x):
            if df == "NHWC":
                x = to_nhwc(x)
            return self.fc(self.flatten(self.pool(self.block(self.stem(x)))))

    return Net()


def _xent(m, img, label):
    return (JF if not isinstance(img, torch.Tensor) else F).cross_entropy(
        m(img), label)


def _vision_batch(seed, n=4, hw=16, classes=5):
    rs = np.random.RandomState(seed)
    img = rs.randn(n, 3, hw, hw).astype("float32")
    lab = rs.randint(0, classes, (n, 1)).astype("int64")
    return img, lab


@pytest.mark.parametrize("opt,amp,fmt", [
    ("momentum", None, "NCHW"), ("momentum", None, "NHWC"),
    ("momentum", "O1", "NHWC"), ("sgd", None, "NHWC")])
def test_small_resnet_train_steps_match_jax(opt, amp, fmt):
    """Three steps of make_train_step at lr 0.1 on both sides: the loss
    of every step, then every parameter and running statistic. The
    reference hands weight_decay to the momentum op as `coeff`, which
    the op does not read; the port does likewise, so 0.5 here changes
    neither side."""
    jm, pm = _pair(
        lambda: _small_net(jnn, jresnet, fmt,
                           lambda x: paddle.transpose(x, [0, 2, 3, 1])),
        lambda: _small_net(pnn, presnet, fmt,
                           lambda x: x.permute(0, 2, 3, 1).contiguous()),
        seed=7)
    jm.train(), pm.train()
    kw = dict(optimizer=opt, lr=0.1, weight_decay=0.5, amp_level=amp)
    jstep = j_make_train_step(jm, _xent, donate=False, **kw)
    pstep = make_train_step(pm, _xent, device="cpu", **kw)
    tol = BF16 if amp else STEP
    for i in range(3):
        img, lab = _vision_batch(i)
        jl = float(np.asarray(jstep(img, lab)).ravel()[0])
        pl = float(pstep(img, lab))
        np.testing.assert_allclose(pl, jl, **tol)
    if amp:
        return
    jstep.write_back(), pstep.write_back()
    for (n, jv), (pn, pv) in zip(
            [*jm.named_parameters(), *jm.named_buffers()],
            [*pm.named_parameters(), *pm.named_buffers()]):
        assert n == pn
        np.testing.assert_allclose(pv.detach().numpy(), jv.numpy(),
                                   err_msg=n, **STEP)


def test_resnet18_trains_on_separable_classes_and_moves_its_buffers():
    """The class-separable recipe of tests/test_vision_models.py on the
    port's resnet18 (momentum, lr 0.05, 6 steps on the CPU): the loss
    falls, the running statistics move every step through
    TrainStep.buffers, and write_back() puts them into the model."""
    pnn.initializer.seed(0)
    model = pmodels.resnet18(num_classes=4, data_format="NHWC").train()
    step = make_train_step(model, _xent, optimizer="momentum", lr=0.05,
                           device="cpu")
    rng = np.random.RandomState(0)
    protos = rng.randn(4, 3, 32, 32).astype("float32") * 2
    name = "layer4.1.conv2.1._variance"
    seen, losses = [step.buffers[name].clone()], []
    for _ in range(6):
        lab = rng.randint(0, 4, (16,))
        img = protos[lab] + rng.randn(16, 3, 32, 32).astype("float32") * .1
        losses.append(float(step(img, lab[:, None].astype("int64"))))
        seen.append(step.buffers[name].clone())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(not torch.equal(a, b) for a, b in zip(seen, seen[1:]))
    assert torch.equal(dict(model.named_buffers())[name],
                       torch.ones_like(seen[0]))
    step.write_back()
    assert torch.equal(dict(model.named_buffers())[name], seen[-1])


def test_resnet_train_step_needs_a_card_or_device_cpu():
    model = pmodels.resnet18(num_classes=4, data_format="NHWC")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, _xent, optimizer="momentum",
                        amp_level="O1")
    step = make_train_step(model, _xent, optimizer="momentum",
                           amp_level="O1", device="cpu")
    assert isinstance(step, TrainStep)
    assert set(step.opt_state[next(iter(step.params))]) == {"Velocity"}


def test_resnet_train_flops_match_bench():
    import bench
    assert resnet_train_flops_per_step(256) == \
        bench.resnet_train_flops_per_step(256) == 6280987017216


# -- layers ------------------------------------------------------------------

def test_layers_keep_paddle_names_and_layouts():
    conv = pnn.Conv2D(4, 6, (3, 2), groups=2, data_format="NHWC")
    assert tuple(conv.weight.shape) == (6, 2, 3, 2)
    bn = pnn.BatchNorm2D(6)
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    seq = pnn.Sequential(pnn.ReLU(), pnn.Identity())
    assert [n for n, _ in seq.named_children()] == ["0", "1"]
    named = pnn.Sequential([("a", pnn.ReLU()), ("b", pnn.ReLU6())])
    assert [n for n, _ in named.named_children()] == ["a", "b"]
    assert float(named(torch.tensor([9.0]))) == 6.0
    loss = pnn.CrossEntropyLoss()(torch.zeros(3, 4),
                                  torch.zeros(3, 1, dtype=torch.int64))
    assert abs(float(loss) - np.log(4)) < 1e-6
    assert tuple(pnn.Flatten()(torch.zeros(2, 3, 4, 5)).shape) == (2, 60)
