"""The port's static graph (paddle_tpu_torch.fluid: Program, layers, the
op registry, append_backward, Adam, Executor) against the JAX package's
on the CPU: the LeNet program of bench_lenet and a program that carries
the fused_ffn op are built by both packages and must have the same ops,
variables, shapes, dtypes and flags; from the reference's startup values
(carried across by name) three training steps must give the same losses,
accuracies, parameters and Adam accumulators. Then the executor's own
behaviour: fan-out gradients, pruning, error paths, the NaN sweep, the
device rule, and the ops that are not ported yet."""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import common_ops as jco
from paddle_tpu.fluid import Executor as JExecutor
from paddle_tpu.fluid import framework as jfw
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import optimizer as jopt
from paddle_tpu.fluid import unique_name as jun
from paddle_tpu.fluid.scope import Scope as JScope
from paddle_tpu.fluid.scope import scope_guard as jscope_guard
from paddle_tpu.models import build_lenet_program as jbuild_lenet

import paddle_tpu_torch as pt
from paddle_tpu_torch import common_ops as tco
from paddle_tpu_torch import static
from paddle_tpu_torch.fluid import (CPUPlace, Executor, Scope, core,
                                    registry, scope_from_numpy, scope_guard)
from paddle_tpu_torch.fluid import framework as tfw
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import optimizer as topt
from paddle_tpu_torch.fluid import unique_name as tun
from paddle_tpu_torch.models.lenet import build_lenet_program

H, I = 128, 512        # the FFN program's widths (aligned: Pallas body)


class _Pkg:
    def __init__(self, mod, co, fw, layers, opt, un):
        self.mod, self.co, self.fw, self.layers = mod, co, fw, layers
        self.opt, self.un = opt, un


JAX = _Pkg(paddle_tpu, jco, jfw, jlayers, jopt, jun)
PORT = _Pkg(pt, tco, tfw, tlayers, topt, tun)


def _lenet(pkg, build):
    pkg.mod.enable_static()
    try:
        with pkg.un.guard():
            main, startup, feeds, fetches = build()
            with pkg.fw.program_guard(main, startup):
                pkg.opt.Adam(learning_rate=1e-3).minimize(fetches["loss"])
    finally:
        pkg.mod.disable_static()
    return main, startup, [fetches["loss"], fetches["acc"]]


def _ffn(pkg):
    pkg.mod.enable_static()
    try:
        with pkg.un.guard():
            main, startup = pkg.fw.Program(), pkg.fw.Program()
            with pkg.fw.program_guard(main, startup):
                x = pkg.layers.data("x", [-1, H], "float32")
                t = pkg.layers.data("t", [-1, H], "float32")
                w1 = pkg.layers.create_parameter([H, I], "float32")
                b1 = pkg.layers.create_parameter([I], "float32",
                                                 is_bias=True)
                w2 = pkg.layers.create_parameter([I, H], "float32")
                b2 = pkg.layers.create_parameter([H], "float32",
                                                 is_bias=True)
                y = pkg.co.run_op("fused_ffn", {"X": x, "W1": w1, "B1": b1,
                                                "W2": w2, "B2": b2},
                                  {"activation": "gelu"})
                d = y - t
                loss = pkg.layers.mean(d * d)
                pkg.opt.Adam(learning_rate=1e-3).minimize(loss)
    finally:
        pkg.mod.disable_static()
    return main, startup, [loss]


PROGRAMS = {
    "lenet": (lambda: _lenet(JAX, jbuild_lenet),
              lambda: _lenet(PORT, build_lenet_program)),
    "ffn": (lambda: _ffn(JAX), lambda: _ffn(PORT)),
}


def _ops(prog):
    return [(op.type, sorted((k, tuple(v)) for k, v in op.inputs.items()),
             sorted((k, tuple(v)) for k, v in op.outputs.items()))
            for op in prog.global_block().ops]


def _vars(prog):
    return [(v.name, v.shape, v.dtype, v.persistable, v.stop_gradient)
            for v in prog.list_vars()]


@pytest.mark.parametrize("which", ["startup", "main"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_programs_have_the_reference_structure(name, which):
    jp, tp = PROGRAMS[name]
    (jm, js, _), (tm, ts, _) = jp(), tp()
    a, b = (jm, tm) if which == "main" else (js, ts)
    assert _ops(b) == _ops(a)
    assert _vars(b) == _vars(a)
    # default attributes filled as the reference fills them
    for oa, ob in zip(a.global_block().ops, b.global_block().ops):
        assert set(ob.attrs) == set(oa.attrs), oa.type


def test_program_op_lists():
    """The op lists of the two programs the port's static graph covers."""
    from collections import Counter
    main, startup, _ = PROGRAMS["lenet"][1]()
    c = Counter(op.type for op in startup.global_block().ops)
    assert c == {"fill_constant": 46, "uniform_random": 3,
                 "gaussian_random": 2}
    c = Counter(op.type for op in main.global_block().ops)
    assert c["adam"] == 10 and c["conv2d"] == 2 and c["mul_grad"] == 3
    main, _, _ = PROGRAMS["ffn"][1]()
    assert [op.type for op in main.global_block().ops] == [
        "fused_ffn", "elementwise_sub", "elementwise_mul", "mean",
        "fill_constant", "mean_grad", "elementwise_mul_grad", "sum",
        "elementwise_sub_grad", "fused_ffn_grad", "adam", "adam", "adam",
        "adam"]


def _lenet_feeds(steps, batch=8):
    rng = np.random.RandomState(0)
    protos = rng.randn(10, 1, 28, 28).astype("float32")
    out = []
    for _ in range(steps):
        lab = rng.randint(0, 10, batch).astype("int64")
        img = protos[lab] + 0.3 * rng.randn(batch, 1, 28, 28) \
            .astype("float32")
        out.append({"img": img, "label": lab[:, None]})
    return out


def _ffn_feeds(steps, m=256):
    rng = np.random.RandomState(1)
    a = (rng.randn(H, H) / np.sqrt(H)).astype("float32")
    out = []
    for _ in range(steps):
        x = rng.randn(m, H).astype("float32")
        out.append({"x": x, "t": np.tanh(x @ a).astype("float32")})
    return out


FEEDS = {"lenet": _lenet_feeds, "ffn": _ffn_feeds}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_three_steps_match_the_reference(name, monkeypatch):
    """From the reference's startup values, three Adam steps: losses
    within 1e-5 relative, accuracies equal, every parameter and
    accumulator within 1e-4 absolute (Adam normalises each gradient, so
    an element whose gradient were rounding noise could step by lr = 1e-3
    in either direction; in these programs a gradient is either exactly
    0 in both packages, as behind a dead relu, or far above the noise).
    The FFN program runs the reference's Pallas body in interpret
    mode."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    jp, tp = PROGRAMS[name]
    (jm, js, jf), (tm, ts, tf) = jp(), tp()
    jscope = JScope()
    with jscope_guard(jscope):
        jexe = JExecutor(paddle_tpu.fluid.CPUPlace())
        jexe.run(js)
    names = [v.name for v in jm.list_vars() if v.persistable]
    start = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = Scope()
    texe = Executor(CPUPlace())
    with scope_guard(tscope):
        texe.run(ts)
        # the port's own startup made every persistable, with the
        # reference's names, shapes and (value) dtypes
        for n in names:
            assert tuple(tscope.find_var(n).shape) == start[n].shape, n
    tscope = scope_from_numpy(start, CPUPlace())
    for feed in FEEDS[name](3):
        with jscope_guard(jscope):
            want = jexe.run(jm, feed=feed, fetch_list=jf)
        with scope_guard(tscope):
            got = texe.run(tm, feed=feed, fetch_list=tf)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    for n in names:
        a, b = np.asarray(jscope.find_var(n)), tscope.numpy(n)
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=n)
    assert texe.stats() == {"runs": 4, "compiles": 2, "cache_hits": 2}


def _fanout_program():
    """loss = mean(y + y), y = x * w: y fans out to two consumers, so its
    gradient is the sum of two grad-op outputs."""
    pt.enable_static()
    try:
        with tun.guard():
            main, startup = tfw.Program(), tfw.Program()
            with tfw.program_guard(main, startup):
                x = tlayers.data("x", [4, 3], "float32")
                w = tlayers.create_parameter([4, 3], "float32")
                y = x * w
                loss = tlayers.mean(y + y)
                pg = static.append_backward(loss)
    finally:
        pt.disable_static()
    return main, startup, x, w, y, loss, pg


def test_append_backward_sums_fan_out():
    main, startup, x, w, y, loss, pg = _fanout_program()
    types = [op.type for op in main.global_block().ops]
    assert types == ["elementwise_mul", "elementwise_add", "mean",
                     "fill_constant", "mean_grad", "elementwise_add_grad",
                     "sum", "elementwise_mul_grad"]
    assert [(p.name, g.name) for p, g in pg] == [(w.name, w.name + "@GRAD")]
    sum_op = main.global_block().ops[6]
    assert sum_op.input("X") == [y.name + "@GRAD",
                                 y.name + "@GRAD@RENAME@1"]
    xv = np.arange(12, dtype="float32").reshape(4, 3)
    with scope_guard(Scope()):
        exe = Executor(CPUPlace())
        exe.run(startup)
        gw, gy = exe.run(main, feed={"x": xv},
                         fetch_list=[w.name + "@GRAD", y.name + "@GRAD"])
    np.testing.assert_allclose(gy, np.full((4, 3), 2 / 12, "float32"),
                               rtol=1e-6)
    np.testing.assert_allclose(gw, xv * 2 / 12, rtol=1e-6)


def test_gradients_of_a_target():
    pt.enable_static()
    try:
        with tun.guard():
            main, startup = tfw.Program(), tfw.Program()
            with tfw.program_guard(main, startup):
                x = tlayers.data("x", [2, 3], "float32", stop_gradient=False)
                y = x * x
                (gx,) = static.gradients([y], [x])
    finally:
        pt.disable_static()
    xv = np.array([[1, 2, 3], [4, 5, 6]], "float32")
    got = Executor(CPUPlace()).run(main, feed={"x": xv}, fetch_list=[gx])[0]
    np.testing.assert_allclose(got, 2 * xv)


def test_use_prune_fetching_the_loss_skips_the_updates():
    main, startup, fetch = _lenet(PORT, build_lenet_program)
    feed = _lenet_feeds(1)[0]
    with scope_guard(Scope()):
        scope = static.global_scope()
        exe = Executor(CPUPlace())
        exe.run(startup)
        before = scope.numpy("fc_0.w_0").copy()
        l1 = exe.run(main, feed=feed, fetch_list=[fetch[0]], use_prune=True)
        l2 = exe.run(main, feed=feed, fetch_list=[fetch[0]], use_prune=True)
        np.testing.assert_array_equal(scope.numpy("fc_0.w_0"), before)
        np.testing.assert_array_equal(l1[0], l2[0])
        exe.run(main, feed=feed, fetch_list=[fetch[0]])
        assert not np.array_equal(scope.numpy("fc_0.w_0"), before)


def test_error_paths():
    main, startup, fetch = _lenet(PORT, build_lenet_program)
    feed = _lenet_feeds(1)[0]
    with scope_guard(Scope()):
        exe = Executor(CPUPlace())
        with pytest.raises(RuntimeError, match="startup"):
            exe.run(main, feed=feed, fetch_list=fetch)
        exe.run(startup)
        with pytest.raises(RuntimeError, match="'label'"):
            exe.run(main, feed={"img": feed["img"]}, fetch_list=fetch)
        with pytest.raises(ValueError, match="'img' has shape"):
            exe.run(main, feed={"img": feed["img"][:, :, :27],
                                "label": feed["label"]}, fetch_list=fetch)
        loss, acc = exe.run(main, feed=feed, fetch_list=fetch)
        assert loss.shape == (1,) and np.isfinite(loss).all()


def test_check_nan_inf():
    main, startup, fetch = _lenet(PORT, build_lenet_program)
    feed = _lenet_feeds(1)[0]
    feed["img"][0, 0, 0, 0] = np.nan
    core.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with scope_guard(Scope()):
            exe = Executor(CPUPlace())
            exe.run(startup)
            with pytest.raises(RuntimeError, match="NaN/Inf"):
                exe.run(main, feed=feed, fetch_list=fetch)
    finally:
        core.set_flags({"FLAGS_check_nan_inf": False})


def test_executor_needs_a_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        Executor()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        scope_from_numpy({"a": np.zeros(2)})
    assert Executor(CPUPlace()).device.type == "cpu"


def test_unported_parts_raise_naming_their_slice():
    pt.enable_static()
    try:
        main = tfw.Program()
        with tfw.program_guard(main, tfw.Program()):
            x = tlayers.data("x", [2, 3], "float32")
            with pytest.raises(NotImplementedError, match="slice 4"):
                main.global_block().append_op(
                    type="dropout", inputs={"X": [x]},
                    outputs={"Out": [x]})
            with pytest.raises(NotImplementedError, match="slice 4"):
                x / x
            with pytest.raises(NotImplementedError, match="slice 4"):
                static.append_backward(tlayers.mean(x), checkpoints=[x])
        with pytest.raises(NotImplementedError, match="slice 4"):
            topt.SGD(learning_rate=0.1)
        with pytest.raises(NotImplementedError, match="slice 4"):
            topt.Adam(learning_rate=0.1, grad_clip=object())
    finally:
        pt.disable_static()
    with pytest.raises(NotImplementedError, match="slice 4"):
        registry.require("conv3d_grad")
    exe = Executor(CPUPlace())
    with pytest.raises(NotImplementedError, match="slice 6"):
        exe.train_from_dataset(main, None)

    class Compiled:
        _program = main
    with pytest.raises(NotImplementedError, match="slice 5"):
        exe.run(Compiled())


def test_static_mode_switch():
    assert pt.in_dynamic_mode()
    with pytest.raises(RuntimeError, match="enable_static"):
        tlayers.fc(tlayers.data("x", [2, 3]), 4)
    pt.enable_static()
    try:
        assert not pt.in_dynamic_mode()
    finally:
        pt.disable_static()
    assert pt.in_dynamic_mode()


def test_random_startup_ops_follow_the_program_seed():
    """uniform/gaussian_random draw from (run seed, _rng_id): a program
    with a random_seed gives the same startup values on every executor,
    and its distributions are the initialisers' (Xavier bound, conv
    normal std)."""
    _, startup, _ = _lenet(PORT, build_lenet_program)
    startup.random_seed = 7
    vals = []
    for _ in range(2):
        with scope_guard(Scope()):
            Executor(CPUPlace()).run(startup)
            vals.append({n: static.global_scope().numpy(n)
                         for n in ("fc_0.w_0", "conv2d_0.w_0")})
    for n in vals[0]:
        np.testing.assert_array_equal(vals[0][n], vals[1][n])
    w = vals[0]["fc_0.w_0"]
    assert np.abs(w).max() <= np.sqrt(6.0 / (400 + 120))
    c = vals[0]["conv2d_0.w_0"]
    assert abs(c.std() - np.sqrt(2.0 / 9)) < 0.1


def test_run_op_multi_in_both_modes():
    """run_op_multi runs an op of several output slots at once in dygraph
    mode and appends it in static mode; both give torch.topk's values."""
    xv = np.random.RandomState(2).randn(3, 5).astype("float32")
    want = torch.topk(torch.from_numpy(xv), 2)
    got = tco.run_op_multi("top_k_v2", {"X": torch.from_numpy(xv)},
                           {"k": 2}, {"Out": 1, "Indices": "int64"})
    torch.testing.assert_close(got["Out"][0], want.values)
    torch.testing.assert_close(got["Indices"][0], want.indices)
    pt.enable_static()
    try:
        with tun.guard():
            main = tfw.Program()
            with tfw.program_guard(main, tfw.Program()):
                x = tlayers.data("x", [3, 5], "float32")
                outs = tco.run_op_multi("top_k_v2", {"X": x}, {"k": 2},
                                        {"Out": 1, "Indices": "int64"})
    finally:
        pt.disable_static()
    assert [op.type for op in main.global_block().ops] == ["top_k_v2"]
    vals, idx = Executor(CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=[outs["Out"][0],
                                          outs["Indices"][0]])
    np.testing.assert_array_equal(vals, want.values.numpy())
    np.testing.assert_array_equal(idx, want.indices.numpy())


def test_set_flags_takes_only_the_flags_the_port_reads():
    with pytest.raises(ValueError, match="unknown flag"):
        core.set_flags({"FLAGS_cudnn_deterministic": True})
    assert core.get_flags("FLAGS_jit_cache_size") == {
        "FLAGS_jit_cache_size": 512}
