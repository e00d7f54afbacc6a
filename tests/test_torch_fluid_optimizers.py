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
    """GradientMerge (a cond op over two sub-blocks) and Recompute wait
    for the sub-block executor, item 12; fleet's gradient_merge and
    recompute flags with them, amp with item 13."""
    with pytest.raises(NotImplementedError, match="item 12"):
        topt.GradientMergeOptimizer(topt.SGD(0.1), k_steps=2)
    with pytest.raises(NotImplementedError, match="item 12"):
        topt.RecomputeOptimizer(topt.SGD(0.1))
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    for flag, item in (("gradient_merge", "12"), ("recompute", "12"),
                       ("amp", "13")):
        st = DistributedStrategy()
        setattr(st, flag, True)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tapply(topt.SGD(0.1), st)


# -- the wrappers and averages ------------------------------------------------

class _Then:
    """An optimizer factory's object whose minimize runs `train`'s
    minimize, then builds `after` (an EMA's update, a ModelAverage),
    as a user's program does."""

    def __init__(self, train, after):
        self.train, self.after, self.tool = train, after, None

    def minimize(self, loss):
        self.train().minimize(loss)
        self.tool = self.after()


def _ema(mod, decay):
    ema = mod.ExponentialMovingAverage(decay)
    ema.update()
    return ema


WRAPPERS = {
    "DGCMomentum": lambda m: m.DGCMomentumOptimizer(
        learning_rate=0.05, momentum=0.9, rampup_begin_step=3,
        sparsity=(0.75,)),
    "DGCMomentumRampup": lambda m: m.DGCMomentumOptimizer(
        learning_rate=0.05, momentum=0.9, rampup_begin_step=100),
    "LocalSGD": lambda m: m.LocalSGDOptimizer(m.SGD(learning_rate=0.1),
                                              k_steps=2),
    "LocalSGDMomentum": lambda m: m.LocalSGDOptimizer(
        m.MomentumOptimizer(learning_rate=0.05, momentum=0.9), k_steps=3,
        begin_step=2),
    "ExponentialMovingAverage": lambda m: _Then(
        lambda: m.SGD(learning_rate=0.1), lambda: _ema(m, 0.9)),
    "ModelAverage": lambda m: _Then(
        lambda: m.SGD(learning_rate=0.1), lambda: m.ModelAverage(0.15)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_and_averages_match_the_reference(name):
    """12 static steps: losses, parameters, accumulators, EMA variables
    and ModelAverage sums within rtol 1e-5."""
    ref, got = _both(lambda: WRAPPERS[name](jopt),
                     lambda: WRAPPERS[name](topt))
    _assert_same(ref, got)
    extra = {"ExponentialMovingAverage": "_ema_", "ModelAverage": "_sum_1",
             "DGCMomentum": "_v_acc", "LocalSGD": "localsgd_step"}
    if name in extra:
        assert any(extra[name] in n for n in ref[1]), sorted(ref[1])


@pytest.mark.parametrize("which", ["ExponentialMovingAverage",
                                   "ModelAverage"])
def test_apply_swaps_in_the_averages_as_the_reference(which):
    """After the 12 steps, `with tool.apply(exe):` holds the averages in
    the parameters' place (the reference's values within rtol 1e-5, not
    the trained ones) and puts the trained parameters back after."""
    def run(mod, fw, layers, un, opt_mod, scope, guard, exe, value):
        opt = WRAPPERS[which](opt_mod)
        main, startup, loss = _regression(mod, fw, layers, un, lambda: opt)
        names = [p.name for p in main.all_parameters()]
        with guard(scope):
            ex = exe()
            if not scope.local_var_names():
                ex.run(startup)
            start = {n: value(scope.find_var(n)).copy()
                     for n in scope.local_var_names()}
            for f in _feeds():
                ex.run(main, feed=f, fetch_list=[loss])
            trained = {n: value(scope.find_var(n)).copy() for n in names}
            with opt.tool.apply(ex):
                applied = {n: value(scope.find_var(n)).copy()
                           for n in names}
            after = {n: value(scope.find_var(n)) for n in names}
        return start, trained, applied, after

    start, jtrained, japplied, _ = run(
        paddle_tpu, jfw, jlayers, jun, jopt, JScope(), jscope_guard,
        JExecutor, np.asarray)
    _, ttrained, tapplied, tafter = run(
        pt, tfw, tlayers, tun, topt, scope_from_numpy(start, CPUPlace()),
        scope_guard, lambda: Executor(CPUPlace()),
        lambda v: v.cpu().numpy())
    for n, v in japplied.items():
        np.testing.assert_allclose(tapplied[n], v, err_msg=n, **TOL)
        assert not np.allclose(v, jtrained[n])
        np.testing.assert_array_equal(tafter[n], ttrained[n])


def test_lookahead_matches_the_reference_s_eager_lookahead():
    """The reference's Lookahead runs eagerly only: its Linear(8, 1)
    trained by Lookahead(SGD 0.1, alpha 0.5, k 3) over the 12 batches,
    against the port's static Lookahead on the same regression from the
    same weights: losses and weights within rtol 1e-5 (the first two
    steps move the fast weights alone, the third syncs)."""
    from paddle_tpu import nn as jnn
    paddle_tpu.disable_static()
    paddle_tpu.seed(3)
    lin = jnn.Linear(8, 1)
    w0 = {"w": lin.weight.numpy().copy(), "b": lin.bias.numpy().copy()}
    la = jopt.LookaheadOptimizer(
        jopt.SGD(learning_rate=0.1, parameter_list=list(lin.parameters())),
        alpha=0.5, k=3)
    jl = []
    for f in _feeds():
        loss = paddle_tpu.mean((lin(paddle_tpu.to_tensor(f["x"]))
                                - paddle_tpu.to_tensor(f["y"])) ** 2)
        loss.backward()
        la.minimize(loss)
        lin.clear_gradients()
        jl.append(float(np.ravel(loss.numpy())[0]))
    jw = {"w": lin.weight.numpy(), "b": lin.bias.numpy()}

    la_t = topt.LookaheadOptimizer(topt.SGD(learning_rate=0.1), alpha=0.5,
                                   k=3)
    main, startup, loss = _regression(pt, tfw, tlayers, tun, lambda: la_t)
    w, b = (p.name for p in main.all_parameters())
    with scope_guard(pt.fluid.Scope()):
        exe = Executor(CPUPlace())
        exe.run(startup)
        scope = pt.fluid.global_scope()
        scope.set(w, torch.as_tensor(w0["w"]))
        scope.set(b, torch.as_tensor(w0["b"]))
        tl = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss])[0])[0])
              for f in _feeds()]
        tw = {"w": scope.numpy(w), "b": scope.numpy(b)}
        slow = scope.numpy(la_t._slow[w].name)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], err_msg=k, **TOL)
    # 12 steps end on a sync: the fast weights are the slow ones
    np.testing.assert_array_equal(slow, tw["w"])
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("flag", ["dgc", "localsgd"])
def test_fleet_dgc_and_localsgd_flags_match_the_reference(flag):
    """fleet's dgc flag replaces the optimizer by DGCMomentum (its
    dgc_configs), localsgd wraps it in LocalSGD (its localsgd_configs),
    as the reference's do: 12 steps within rtol 1e-5."""
    def make(apply, strategy_cls, opt_mod):
        def f():
            st = strategy_cls()
            setattr(st, flag, True)
            st.dgc_configs = dict(st.dgc_configs, rampup_begin_step=2,
                                  sparsity=[0.5])
            st.localsgd_configs = {"k_steps": 3, "begin_step": 1}
            inner = opt_mod.MomentumOptimizer(learning_rate=0.05,
                                              momentum=0.8)
            return apply(inner, st, None)
        return f
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    tst = DistributedStrategy()
    setattr(tst, flag, True)
    wrapped = tapply(topt.SGDOptimizer(0.1), tst)
    assert type(wrapped).__name__ == {
        "dgc": "DGCMomentumOptimizer", "localsgd": "LocalSGDOptimizer"}[flag]
    ref, got = _both(make(japply, JStrategy, jopt),
                     make(tapply, DistributedStrategy, topt))
    _assert_same(ref, got)


def _reference_localsgd_dp2(how):
    """The reference's dp = 2 run (its executor's mesh on 2 of the
    virtual devices) of tests/torch_dp_workers.py's regression with SGD
    wrapped in LocalSGD(k_steps=3), directly or by fleet's flag."""
    import jax
    from jax.sharding import Mesh
    import torch_dp_workers as W
    from paddle_tpu import fluid
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.fluid.compiler import CompiledProgram
    paddle_tpu.enable_static()
    try:
        main, startup, loss, sgd = W.build_regression(fluid)
        # the optimizer's names from a fresh generator, as the workers'
        with fluid.framework.program_guard(main, startup), jun.guard():
            if how == "fleet_localsgd":
                from paddle_tpu.distributed import fleet
                fleet.init(is_collective=True)
                st = fleet.DistributedStrategy()
                st.localsgd = True
                st.localsgd_configs = {"k_steps": 3, "begin_step": 1}
                fleet.distributed_optimizer(sgd, st).minimize(loss)
                prog = main
            else:
                jopt.LocalSGDOptimizer(sgd, k_steps=3).minimize(loss)
                prog = CompiledProgram(main).with_data_parallel(loss.name)
        prev = jmesh.get_mesh()
        jmesh.set_mesh(Mesh(np.array(jax.devices()[:2]), ("dp",)))
        try:
            scope = JScope()
            with jscope_guard(scope):
                exe = JExecutor()
                exe.run(startup)
                start = {n: np.asarray(scope.find_var(n)).copy()
                         for n in scope.local_var_names()}
                losses = [float(exe.run(prog, feed=f,
                                        fetch_list=[loss])[0][0])
                          for f in W.regression_feeds()]
                params = {p.name: np.asarray(scope.find_var(p.name))
                          for p in main.all_parameters()}
        finally:
            jmesh._mesh = prev
    finally:
        paddle_tpu.disable_static()
    return start, losses, params


@pytest.mark.parametrize("how", ["localsgd", "fleet_localsgd"])
def test_localsgd_over_two_gloo_ranks_matches_the_reference(how, tmp_path):
    """LocalSGD (and fleet's localsgd flag) at dp = 2 over two gloo
    processes (tests/torch_dp_workers.py static_dp): every third step
    each parameter becomes its average over the ranks (localsgd_sync's
    all-reduce); 20 steps against the reference's dp = 2 mesh run,
    within the data-parallel tests' tolerance (rtol 2e-3, atol 1e-4)."""
    import os
    import pickle
    import torch_dp_workers as W
    from paddle_tpu_torch.distributed import spawn
    start, jl, jp = _reference_localsgd_dp2(how)
    assert jl[-1] < 0.2 * jl[0]
    spawn(W.run, args=("static_dp", str(tmp_path), start, how), nprocs=2,
          timeout=60)
    for r in range(2):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            out = pickle.load(f)
        assert out["info"]["mode"] == "dp"
        np.testing.assert_allclose(out["losses"], jl, rtol=2e-3, atol=1e-4)
        for n, w in jp.items():
            np.testing.assert_allclose(out["params"][n], w, rtol=2e-3,
                                       atol=1e-4, err_msg=n)
