"""The port's fluid optimizers (paddle_tpu_torch/fluid/optimizer.py)
against the JAX package's on the CPU: tests/test_optimizers_extra.py's
_static_regression program (x (-1, 8) -> fc 1, mean squared error)
built by both packages with each optimizer, the reference's startup
values carried into the port by name, 12 steps on the same batches:
losses, parameters and accumulators within rtol 1e-5 / atol 1e-6. The
same for TrainStep(optimizer="lamb") on a small Linear, and for the
fleet strategy's lamb and lars flags, which replace the user's
optimizer as the reference's do. The optimizers still queued raise
naming their item."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
from paddle_tpu.distributed.fleet.base.distributed_strategy import \
    DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet.meta_optimizers import \
    apply_meta_optimizers as japply
from paddle_tpu.fluid import Executor as JExecutor
from paddle_tpu.fluid import framework as jfw
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import optimizer as jopt
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.scope import Scope as JScope
from paddle_tpu.fluid.scope import scope_guard as jscope_guard
from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
    apply_meta_optimizers as tapply
from paddle_tpu_torch.fluid import (CPUPlace, Executor, scope_from_numpy,
                                    scope_guard)
from paddle_tpu_torch.fluid import framework as tfw
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import optimizer as topt
from paddle_tpu_torch.fluid import unique_name as tun

TOL = dict(rtol=1e-5, atol=1e-6)
STEPS = 12

OPTIMIZERS = {
    "Momentum": dict(learning_rate=0.05, momentum=0.9),
    "MomentumNesterov": dict(learning_rate=0.05, momentum=0.9,
                             use_nesterov=True),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "Adamax": dict(learning_rate=0.05),
    "RMSProp": dict(learning_rate=0.01, momentum=0.5),
    "RMSPropCentered": dict(learning_rate=0.01, centered=True),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "Lamb": dict(learning_rate=0.05, lamb_weight_decay=0.01),
    "Ftrl": dict(learning_rate=0.1, l1=0.01, l2=0.01),
    "DecayedAdagrad": dict(learning_rate=0.1),
    "LarsMomentum": dict(learning_rate=1.0, momentum=0.9, lars_coeff=0.05),
}


def _class(mod, name):
    base = name.replace("Nesterov", "").replace("Centered", "")
    return getattr(mod, base + "Optimizer")


def _regression(mod, fw, layers, un, make_opt):
    mod.enable_static()
    try:
        with un.guard():
            main, startup = fw.Program(), fw.Program()
            main.random_seed = startup.random_seed = 7
            with fw.program_guard(main, startup):
                x = layers.data("x", [-1, 8], "float32")
                y = layers.data("y", [-1, 1], "float32")
                pred = layers.fc(x, 1)
                d = layers.elementwise_sub(pred, y)
                loss = layers.mean(layers.elementwise_mul(d, d))
                make_opt().minimize(loss)
    finally:
        mod.disable_static()
    return main, startup, loss


def _feeds():
    rng = np.random.RandomState(7)
    w_true = rng.randn(8, 1).astype("float32")
    out = []
    for _ in range(STEPS):
        xb = rng.randn(32, 8).astype("float32")
        out.append({"x": xb, "y": xb @ w_true})
    return out


def _both(jmake, tmake):
    """12 steps in each package from the reference's startup values:
    (losses, end state) of the reference, then of the port."""
    jm, js, jl = _regression(paddle_tpu, jfw, jlayers, jun, jmake)
    tm, ts, tl = _regression(pt, tfw, tlayers, tun, tmake)
    assert [o.type for o in tm.global_block().ops] == \
        [o.type for o in jm.global_block().ops]
    feeds = _feeds()
    scope = JScope()
    with jscope_guard(scope):
        exe = JExecutor()
        exe.run(js)
        start = {n: np.asarray(scope.find_var(n)).copy()
                 for n in scope.local_var_names()}
        jlosses = [float(np.ravel(exe.run(jm, feed=f, fetch_list=[jl])[0])[0])
                   for f in feeds]
        jend = {n: np.asarray(scope.find_var(n)) for n in start}
    tscope = scope_from_numpy(start, CPUPlace())
    with scope_guard(tscope):
        exe = Executor(CPUPlace())
        tlosses = [float(np.ravel(exe.run(tm, feed=f, fetch_list=[tl])[0])[0])
                   for f in feeds]
        tend = {n: tscope.find_var(n).cpu().numpy() for n in start}
    return (jlosses, jend), (tlosses, tend)


def _assert_same(ref, got):
    (jl, jend), (tl, tend) = ref, got
    np.testing.assert_allclose(tl, jl, **TOL)
    for n, v in jend.items():
        np.testing.assert_allclose(tend[n], v, err_msg=n, **TOL)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_twelve_static_steps_match_the_reference(name):
    kw = OPTIMIZERS[name]
    ref, got = _both(lambda: _class(jopt, name)(**kw),
                     lambda: _class(topt, name)(**kw))
    _assert_same(ref, got)


@pytest.mark.parametrize("flag", ["lamb", "lars"])
def test_fleet_flags_wrap_the_optimizer_as_the_reference(flag):
    def make(apply, strategy_cls, opt_mod):
        def f():
            st = strategy_cls()
            setattr(st, flag, True)
            # LARS' local lr scales by lars_coeff: a large one stands in
            # for the large batches it was built for
            st.lars_configs = dict(st.lars_configs, lars_coeff=0.05)
            inner = opt_mod.MomentumOptimizer(learning_rate=0.5,
                                              momentum=0.8)
            return apply(inner, st, None)
        return f
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    tst = DistributedStrategy()
    setattr(tst, flag, True)
    wrapped = tapply(topt.SGDOptimizer(0.1), tst)
    assert type(wrapped).__name__ == {"lamb": "LambOptimizer",
                                      "lars": "LarsMomentumOptimizer"}[flag]
    ref, got = _both(make(japply, JStrategy, jopt),
                     make(tapply, DistributedStrategy, topt))
    _assert_same(ref, got)


def test_train_step_lamb_matches_the_reference():
    """TrainStep(optimizer="lamb") on a Linear(8, 1) regression: 12
    steps, losses and weights within rtol 1e-5 of the reference's
    jit.TrainStep."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.jit.functional import make_train_step as jmake
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.jit import make_train_step as tmake
    paddle_tpu.disable_static()
    paddle_tpu.seed(3)
    jlin = jnn.Linear(8, 1)
    tlin = tnn.Linear(8, 1)
    with torch.no_grad():
        for n, p in tlin.named_parameters():
            p.copy_(torch.as_tensor(
                dict(jlin.named_parameters())[n].numpy()))
    feeds = _feeds()
    kw = dict(optimizer="lamb", lr=0.05, epsilon=1e-6)
    jstep = jmake(jlin, lambda m, x, y: paddle_tpu.mean(
        paddle_tpu.square(m(x) - y)), **kw)
    tstep = tmake(tlin, lambda m, x, y: ((m(x) - y) ** 2).mean(),
                  device="cpu", **kw)
    jl = [float(np.asarray(jstep(f["x"], f["y"]))) for f in feeds]
    tl = [float(tstep(f["x"], f["y"])) for f in feeds]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    jw = {n: np.asarray(v) for n, v in zip(
        [n for n, _ in jlin.named_parameters()], jstep.param_vals)}
    for n, v in tstep.params.items():
        np.testing.assert_allclose(v.detach().numpy(), jw[n], err_msg=n,
                                   **TOL)


def test_the_queued_optimizers_raise_naming_their_item():
    for name in ("DGCMomentumOptimizer", "GradientMergeOptimizer",
                 "LocalSGDOptimizer", "LookaheadOptimizer", "ModelAverage",
                 "ExponentialMovingAverage"):
        with pytest.raises(NotImplementedError, match="item 11"):
            getattr(topt, name)(0.1)
    with pytest.raises(NotImplementedError, match="item 12"):
        topt.RecomputeOptimizer(topt.SGD(0.1))
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    for flag, item in (("dgc", "11"), ("gradient_merge", "11"),
                       ("localsgd", "11"), ("recompute", "12"),
                       ("amp", "13")):
        st = DistributedStrategy()
        setattr(st, flag, True)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tapply(topt.SGD(0.1), st)
